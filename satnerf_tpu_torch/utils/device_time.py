"""Device time from a torch.profiler profile: the one sum that the bench
(cli/bench.py) and tools/profile_render_torch.py both read, so that their
device-ms cannot drift apart.

A profile's events on the card are kernels, copies and fills; a user
annotation such as Optimizer.step#Adam.step also carries a device time, but
that is its region's span on the timeline, gaps included, not work, and is
left out.
"""

from __future__ import annotations


def on_device(e) -> bool:
    """A kernel, copy or fill on the card (an entry of key_averages())."""
    return (getattr(e, "device_time_total", 0) > 0
            and str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False))


def kernel_rows(prof, name: str = "") -> list:
    """(device ms, launches, key) of every kernel, copy or fill in the
    profile whose key holds `name`, the longest first."""
    rows = [(e.device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages() if on_device(e) and name in e.key]
    return sorted(rows, reverse=True)


def device_ms(prof, name: str = "") -> float:
    """The summed device time of the profile's kernels, copies and fills
    (those whose key holds `name`), in ms."""
    return sum(r[0] for r in kernel_rows(prof, name))
