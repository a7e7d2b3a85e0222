"""What a torch.profiler trace of a stretch of the window says: the device's
busy time (the union of its kernels' intervals), each kernel's summed time
by name, and the longest idle gaps named by the benchmark's span that was
open on the host when each began."""

from __future__ import annotations

import torch

SPAN_PREFIX = "vdbench."


def _interval(e):
    return e.time_range.start, e.time_range.end


def summarize(prof, wall_s: float, top: int = 10) -> dict:
    events = list(prof.events())
    # device activity: kernels, copies and sets; not the device-side
    # ranges the profiler draws for the host's record_function spans
    kernels = sorted((e for e in events
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and not e.name.startswith(SPAN_PREFIX)),
                     key=lambda e: e.time_range.start)
    spans = sorted((_interval(e) + (e.name[len(SPAN_PREFIX):],)
                    for e in events if e.name.startswith(SPAN_PREFIX)
                    and e.device_type == torch.autograd.DeviceType.CPU))
    busy_us, end, gaps = 0.0, None, []
    for e in kernels:
        s, t = _interval(e)
        if end is not None and s > end:
            gaps.append((s - end, end))
        busy_us += max(0.0, t - max(s, end if end is not None else s))
        end = t if end is None else max(end, t)
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e6

    def host_at(us: float) -> str:
        open_ = [n for s, t, n in spans if s <= us < t]
        return open_[-1] if open_ else "host"

    gaps.sort(reverse=True)
    return {
        "busy_s": busy_us / 1e6,
        "window_s": wall_s,
        "kernels": by_name,
        "device_ops": sorted(([n, s] for n, s in by_name.items()),
                             key=lambda x: -x[1])[:top],
        "idle_gaps": [[host_at(at), us / 1e6] for us, at in gaps[:top]],
    }


def kernel_seconds(summary: dict | None, names) -> float | None:
    """Summed time of the kernels whose names hold any of `names` (the
    profiler writes a template's return type and arguments around its
    name), None without a trace or where none ran."""
    if not summary:
        return None
    total = sum(s for n, s in summary["kernels"].items()
                if any(p in n for p in names))
    return total or None
