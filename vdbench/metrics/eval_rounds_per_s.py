"""eval_rounds_per_s: every round ranked (100 candidates each) in the window's
whole evaluate_split passes over the window's time (host clock)."""


def read(r):
    if r["kind"] != "eval":
        return None
    return r["rounds"] / r["window_s"]
