"""setup_host_build_s: seconds of set-up in the port's host-side
builds (span build.host: data/loader.py's BatchAssembler, the resident
eval's stacks in eval_harness.py)."""

from vdbench import metrics as shared


def read(r):
    return shared.setup_seconds(r, "build.host")
