"""train_rounds_per_s: every dialog round trained in the window (all ranks)
over the window's time, whole dispatches, ended by the device (host clock)."""


def read(r):
    if r["kind"] != "train":
        return None
    return r["rounds"] / r["window_s"]
