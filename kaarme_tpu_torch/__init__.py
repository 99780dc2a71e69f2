"""kaarme_tpu_torch — the PyTorch + CUDA port of kaarme_tpu.

The single-device super-k-mer pipeline on an NVIDIA H100, held exactly
to the JAX package (``kaarme_tpu``), which stays the reference.

Layout
------
- ``cli``      the reference CLI surface, plus ``--device`` and ``--kernels``
- ``models``   streaming counters (``SortKmerCounter`` base, ``SkmCounter``)
- ``ops``      PyTorch ops of the pipeline and the wrappers of the CUDA
               kernels (K1 ``cuda_skm``, K2 ``cuda_compact``; ``_build``
               compiles ``csrc/*.cu`` with nvcc at first use)
- ``io``       host 2-bit packing
- ``utils``    device resolution, store conversion between the packages
"""
