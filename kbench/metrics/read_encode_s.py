"""read_encode_s: one pass of the port's reader (``io.reader.CodeChunkReader``:
the file read and the encode to codes) over the cell's input, timed by
the harness after the window, with no counting: the io layer alone."""

import time


def read(rec):
    from kaarme_tpu_torch.io.reader import CodeChunkReader

    t0 = time.perf_counter()
    for _ in CodeChunkReader(rec["input"]["path"]):
        pass
    return time.perf_counter() - t0
