"""kernels_roofline: the share of the jobs' kernel time that the least
device time of their work would take.  The work is the job's, not its
kernels': its 2-bit codes read once, its distinct store rows (key words
and count) written once and its count file's text written once, at the
HBM rate of one card (``kbench/roofline.py``; bytes set the bound, no
operations are counted).  The time is the summed device time of every
kernel and library kernel in the traced window (copies and memsets
excluded), summed over the cell's cards too, over the window's whole
jobs: a job's least bytes at one card's rate against all the kernel
time the job took on every card."""

from kbench import roofline


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["kernel_s"] <= 0 or not rec["jobs"]:
        return None
    out = rec["judged"]
    nbytes = roofline.job_bytes(rec["input"]["codes"], out["store_rows"], out["key_words"],
                                out["text_bytes"])
    return 100.0 * roofline.bound_s(nbytes) * len(rec["jobs"]) / tr["kernel_s"]
