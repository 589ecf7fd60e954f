"""Profiler windows for the card tests (``tests/test_torch_cuda_*.py``).

The tracer now and then loses every device record of a window, at times
several windows in a row (``scripts/profile_window_probe.py`` measures
it). ``device_kernel_names`` takes such a window again, up to eight
times, as ``chip_smoke.py``'s ``retaken_window`` does, so that a test's
kernel counts are read from a window that holds its records.
"""
import torch


def device_kernel_names(fn, tries: int = 8) -> list:
    """Names of the device kernels (and copies) of one profiler window
    around ``fn()``. Tracing starts one step early, on a small op: the
    tracer's start-up can miss a window's first records. A window with no
    device record at all is taken again, up to ``tries`` windows; the
    last window's names are returned whatever they hold."""
    from torch.profiler import ProfilerActivity, profile, schedule
    names = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            prof.step()
            fn()
            torch.cuda.synchronize()
            prof.step()
        names = [e.name for e in prof.events()
                 if str(getattr(e, "device_type", "")).endswith("CUDA")
                 and not e.name.startswith("ProfilerStep")]
        if names:
            break
    return names
