"""kaarme_tpu_torch — the PyTorch + CUDA port of kaarme_tpu.

Every single-device route on an NVIDIA H100 (the sort backend's
super-k-mer pipeline and classic pipeline with its linear-merge variant,
and the probe-table backend, each with the two-pass Bloom prefilter),
held exactly to the JAX package (``kaarme_tpu``), which stays the
reference.

Layout
------
- ``cli``      the reference CLI surface, plus ``--device`` and ``--kernels``
- ``models``   streaming counters (``SortKmerCounter``: the classic
               pipeline and the base of ``SkmCounter``; ``KmerCounter``:
               the probe table)
- ``ops``      PyTorch ops of the pipelines and the wrappers of the CUDA
               kernels (K1 and K5 ``cuda_skm``, K2 ``cuda_compact``, K3
               ``cuda_winkeys``, K4 ``cuda_merge``, the table insert T1
               ``cuda_table``; ``_build`` compiles ``csrc/*.cu`` with
               nvcc at first use)
- ``io``       the host input layer: format sniffing, chunked (gzip)
               reading, encoding and 2-bit packing; its native encoder
               (``csrc/host/_fastio.cpp``) is built by g++ at first use
- ``utils``    the 2-bit codec, table and Bloom sizing, device
               resolution, store and table conversion between the
               packages, the count-file comparator

It imports torch and numpy, never jax and nothing of ``kaarme_tpu``.
"""
