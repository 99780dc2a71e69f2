"""device_idle_pct: the mean over the cell's cards of the share of the
traced window in which no kernel, copy or memset ran on that card
(``torch.profiler``; ``trace.device_summary``'s ``busy_s`` is the mean
of the cards' busy times)."""


def read(rec):
    tr = rec.get("trace")
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
