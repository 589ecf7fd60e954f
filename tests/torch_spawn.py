"""Workers of the port's multi-rank CPU tests.

The tests start their gloo worlds with ``repro_torch.launch.spawn.run_world``
(spawned processes, a ``file://`` rendezvous under the test's tmp dir).
The functions the ranks run live here, in a module that imports ``torch``
and ``repro_torch`` only, never in a test module that imports JAX.
"""
from __future__ import annotations

def worker_losses(rank, world, cases, device="cpu"):
    """The cross-shard losses on this rank's rows of each case's global
    embeddings on ``device``: ``cases`` maps a name to (method, dtype name,
    x, y, log_tau), x and y float32 numpy (B, D) cast to the dtype.
    Returns {name: (loss, dx block, dy block, dlog_tau partial)} as float32
    numpy, and under "launches" {name: this rank's contrastive kernel
    launches in that case's loss and backward} (0 on the CPU, where the
    plain versions run)."""
    import torch

    from repro_torch.core import distributed_loss as dl
    from repro_torch.kernels.contrastive_loss import ops
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh()
    counters = (ops.FWD_COUNTER, ops.BWD_COUNTER)
    out, launches = {}, {}
    for name, (method, dtype, x, y, log_tau) in cases.items():
        dt = getattr(torch, dtype)
        b = x.shape[0] // world
        rows = slice(rank * b, (rank + 1) * b)
        xl = torch.from_numpy(x[rows]).to(device, dt).requires_grad_()
        yl = torch.from_numpy(y[rows]).to(device, dt).requires_grad_()
        lt = torch.tensor(log_tau, dtype=torch.float32, device=device,
                          requires_grad=True)
        loss_fn = dl.make_global_loss_fn(mesh, method)
        for c in counters:
            c.reset()
        loss, _ = loss_fn(xl, yl, torch.exp(lt))
        dx, dy, dtau = torch.autograd.grad(loss, (xl, yl, lt))
        launches[name] = {c.name: c.count for c in counters}
        out[name] = tuple(t.detach().float().cpu().numpy()
                          for t in (loss, dx, dy, dtau))
    out["launches"] = launches
    return out


def worker_train(rank, world, argvs):
    """``repro_torch.launch.train_distributed.main(argv)`` for each argv in
    turn on this rank (in the world's gloo group); returns each run's
    per-step losses."""
    from repro_torch.launch import train_distributed as td
    return [td.main(argv) for argv in argvs]
