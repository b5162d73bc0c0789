"""One rank of the port's distributed MD and evaluation, started by
tests/test_torch_parallel.py in its own process (spawned: it imports torch
and the port only, never JAX). :func:`run_rank` starts a ``gloo`` group
from a ``file://`` rendezvous and runs a dict of named jobs in order, all
ranks together; rank 0 writes each job's results (or the error it raised)
to ``{out}/{name}.npz``."""

import numpy as np
import torch


def _spec_params(model, tree):
    from sevennet_tpu_torch.io.convert import params_from_numpy
    from sevennet_tpu_torch.model.build import build_model_spec

    spec = build_model_spec(model)
    return spec, params_from_numpy(spec, tree)


def _engine(job):
    from sevennet_tpu_torch.parallel.md import DistributedMDEngine

    spec, params = _spec_params(job["model"], job["tree"])
    eng = DistributedMDEngine(spec, params, job["cell"], dims=job["dims"], device="cpu",
                              **job.get("engine_kw", {}))
    st = eng.make_state(job["positions"], job["numbers"], velocities=job.get("velocities"),
                        temperature=job.get("temperature"), seed=job.get("seed", 0))
    out = {"forces0": eng.gather(st, st.forces), "pe0": st.potential_energy.numpy()}
    st, (pe, ke) = eng.run(st, job["steps"], dt=job.get("dt", 1.0), chunk=job.get("chunk", 10),
                           integrator=job.get("integrator", "nve"), **job.get("run_kw", {}))
    out.update(pe=pe.numpy(), ke=ke.numpy(), positions=eng.gather_positions(st),
               n_atoms=eng.halo.all_reduce(st.atom_mask.sum()).numpy(),
               n_rebuilds=np.asarray(eng.n_rebuilds),
               n_migrated=eng.halo.all_reduce(torch.tensor(eng.n_migrated)).numpy(),
               cell_scale=st.cell_scale.numpy())
    if job.get("stress"):
        e, stress, _ = eng.compute_stress(st)
        out.update(stress_e=e.numpy(), stress=stress.numpy(),
                   positions_ordered=eng.gather(st, st.positions))
    return out


def _compute(job):
    from sevennet_tpu_torch.parallel.model import distributed_compute
    from sevennet_tpu_torch.parallel.partition import partition_system

    spec, params = _spec_params(job["model"], job["tree"])
    species = spec.z_to_type[np.asarray(job["numbers"])]
    dd = partition_system(job["positions"], species, job["cell"], spec.cutoff, job["world"])
    res = {}
    for fused in (False, True):
        out = distributed_compute(spec, params, dd, device="cpu", fused=fused)
        res.update({f"{k}_{'fused' if fused else 'plain'}": v.detach().numpy()
                    for k, v in out.items()})
    return res


class _Take(torch.autograd.Function):
    """This rank's rows of the input every rank holds; the backward sums
    the ranks' gradients, so each holds the gradient of the whole."""

    @staticmethod
    def forward(ctx, x, halo, n):
        ctx.halo, ctx.n = halo, n
        return x[halo.rank * n:(halo.rank + 1) * n].clone()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros((ctx.halo.size * ctx.n,) + g.shape[1:])
        full[ctx.halo.rank * ctx.n:(ctx.halo.rank + 1) * ctx.n] = g
        return ctx.halo.all_reduce(full), None, None


class _Sum(torch.autograd.Function):
    """The sum over the ranks; every rank holds it and its gradient."""

    @staticmethod
    def forward(ctx, y, halo):
        return halo.all_reduce(y)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gradcheck(job):
    """:class:`HaloExchange` alone, chained over the stages of ``dims``, in
    float64, under ``torch.autograd.gradcheck``. Every rank holds the whole
    input (each rank's rows) and the whole output (the sum over the ranks
    of each rank's extended rows, weighted), so the numerical Jacobian,
    which perturbs the input on every rank at once, and the analytical one,
    whose backward crosses ranks, describe the same function."""
    from sevennet_tpu_torch.parallel.comm import Halo, HaloExchange

    halo = Halo(job["dims"], torch.device("cpu"))
    gen = torch.Generator().manual_seed(100 + halo.rank)
    n, s = 6, 3
    maps = []
    for _ in job["dims"]:
        rows = n + 2 * s * len(maps)
        maps.append((torch.randint(0, rows, (s,), generator=gen), torch.rand(s, generator=gen) > 0.3,
                     torch.randint(0, rows, (s,), generator=gen), torch.rand(s, generator=gen) > 0.3))
    x = torch.randn((halo.size * n, 2), generator=torch.Generator().manual_seed(7),
                    dtype=torch.float64, requires_grad=True)
    w = torch.randn((n + 2 * s * len(maps), 2), generator=gen, dtype=torch.float64)

    def fn(x):
        y = _Take.apply(x, halo, n)
        for axis, m in enumerate(maps):
            y = HaloExchange.apply(y, halo, axis, *m)
        return _Sum.apply(y * w, halo)

    ok = torch.autograd.gradcheck(fn, (x,), eps=1e-6, atol=1e-8)
    return {"ok": np.asarray(ok), "swaps": np.asarray(halo.n_swaps)}


def _overflow(job):
    try:
        _engine(job)
    except RuntimeError as exc:
        return {"raised": np.asarray(str(exc))}
    return {"raised": np.asarray("")}


JOBS = {"engine": _engine, "compute": _compute, "gradcheck": _gradcheck, "overflow": _overflow}


def run_rank(rank, world, init_method, jobs, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method, rank=rank, world_size=world)
    try:
        for name, job in jobs.items():
            try:
                res = JOBS[job["kind"]](job)
            except Exception as exc:  # reported by the test that reads it
                res = {"error": np.asarray(f"{type(exc).__name__}: {exc}")}
            if rank == 0:
                np.savez(f"{out}/{name}.npz", **res)
            dist.barrier()
    finally:
        dist.destroy_process_group()
