"""The rank side of `test_torch_multidevice.py`: one spawn of 4 `gloo`
CPU ranks runs every sharded check of the port and writes what it saw.

Each rank joins a process group through a `file://` store in the test's
temporary directory (no ports, so parallel test workers never collide),
builds a (2, 2) ("data", "model") mesh and runs, on the numpy inputs the
test wrote to `inputs.npz`:
  * the CNN `sgd_step`, the generator's `gen_sgd_step` and the GAN's
    `gan_sgd_step` on params laid out by `tree_shardings` and batches
    laid out by `batch_pspec`, under `use_mesh`;
  * one conv layer (bias + relu epilogue) forward and backward, counting
    the kernel wrappers' calls and the shapes they were given;
  * `ConvTrainer` on the mesh for 4 steps, checkpointed at step 2 and
    stopped there by a host failure; then `elastic_mesh(survivors(...))`
    after the loss of host 1 (ranks 2 and 3), restored onto it and run
    to step 4; rank 0 then runs the same trainer alone, with no mesh.
DTensor's own redistribution is made to raise: every collective must be
one of `parallel.sharding`'s.  Each rank writes `results_<rank>.pt`.
"""
from __future__ import annotations

import collections
import os

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4


def _guard_dtensor_collectives():
    """Any DTensor-issued collective raises (on the card `gloo` cannot
    run them; `parallel.sharding` never needs them): the public
    redistribution, the one op dispatch runs to reshard operands, and the
    functional collectives under both."""
    import torch.distributed._functional_collectives as funcol
    import torch.distributed.tensor._dispatch as dispatch
    from torch.distributed.tensor import DTensor

    def refuse(*a, **k):
        raise AssertionError("a DTensor collective was issued")

    DTensor.redistribute = refuse
    DTensor.full_tensor = refuse
    dispatch.redistribute_local_tensor = refuse
    for name in ("all_gather_tensor", "all_reduce", "reduce_scatter_tensor",
                 "all_to_all_single", "broadcast"):
        if hasattr(funcol, name):
            setattr(funcol, name, refuse)


def _whole(tree):
    from repro_torch.models.layers import tree_map
    from repro_torch.parallel import sharding as sh
    return tree_map(lambda t: sh.full_tensor(t).detach().clone(), tree)


def _put(tree, mesh):
    from repro_torch.parallel import sharding as sh
    return sh.device_put(tree, sh.tree_shardings(tree, mesh))


def _batch(a, mesh):
    from repro_torch.parallel import sharding as sh
    return sh.device_put(a, sh.NamedSharding(
        mesh, sh.batch_pspec(mesh, a.dim(), 0, a.shape[0])))


def _steps(mesh, inp, out):
    from repro_torch.models import cnn, gan
    from repro_torch.parallel import sharding as sh
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    kw = dict(backend="cuda", fuse_epilogue=True)
    with sh.use_mesh(mesh):
        p = {"convs": [t["cnn_w0"], t["cnn_w1"]], "head": t["cnn_head"]}
        new, loss = cnn.sgd_step(_put(p, mesh), _batch(t["cnn_x"], mesh),
                                 _batch(t["cnn_labels"], mesh), lr=0.05,
                                 stride=2, **kw)
        out["cnn"] = (_whole(new), loss.item())
        g = {k: t["g_" + k] for k in ("proj", "t1", "t2", "t3")}
        d = {k: t["d_" + k] for k in ("c1", "c2", "c3", "head")}
        new_g, loss = gan.gen_sgd_step(_put(g, mesh), _put(d, mesh),
                                       _batch(t["z"], mesh), lr=0.05, **kw)
        out["gen"] = (_whole(new_g), loss.item())
        new, g_loss, d_loss = gan.gan_sgd_step(
            _put({"g": g, "d": d}, mesh), _batch(t["z"], mesh),
            _batch(t["real"], mesh), lr=0.05, **kw)
        out["gan"] = (_whole(new), g_loss.item(), d_loss.item())


def _one_layer(mesh, inp, out):
    """One conv layer's forward + backward: the kernel wrappers called
    and the shapes they were given (what the planner sees on the card)."""
    from repro_torch.core.conv import ecoflow_conv
    from repro_torch.core.spec import Epilogue
    from repro_torch.kernels import ops
    from repro_torch.parallel import sharding as sh
    seen = collections.Counter()
    shapes = []
    saved = {}
    for name, pos in (("dconv_forward", (0, None)),
                      ("conv_backward", (0, 1))):
        saved[name] = getattr(ops, name)

        def spy(*a, _f=saved[name], _n=name, _p=pos, **k):
            seen[_n] += 1
            shapes.append((_n, tuple(a[_p[0]].shape),
                           None if _p[1] is None else tuple(a[_p[1]].shape),
                           tuple(a[-1].shape) if _n == "conv_backward"
                           else tuple(a[1].shape)))
            return _f(*a, **k)
        setattr(ops, name, spy)
    try:
        t = {k: torch.from_numpy(inp[k]) for k in ("l_x", "l_w", "l_b")}
        with sh.use_mesh(mesh):
            x = _batch(t["l_x"], mesh).requires_grad_()
            w = _put(t["l_w"], mesh).requires_grad_()
            b = sh.device_put(t["l_b"], sh.NamedSharding(mesh, (None,))) \
                .requires_grad_()
            ep = Epilogue(activation="relu", bias=True)
            y = ecoflow_conv(x, w, 2, 1, "cuda", bias=b, epilogue=ep)
            loss = sh.unshard(y).sum()
            dx, dw, db = torch.autograd.grad(loss, [x, w, b])
        out["layer"] = {"launches": dict(seen), "shapes": shapes,
                        "grads": _whole([dx, dw, db]),
                        "placements": [str(a.placements)
                                       for a in (dx, dw, db)]}
    finally:
        for name, f in saved.items():
            setattr(ops, name, f)


def _elastic(mesh, rank, tmp, out):
    from repro_torch.train import fault_tolerance as ft
    from repro_torch.train.conv_trainer import ConvTrainer, ConvTrainerConfig
    ckpt_dir = os.path.join(tmp, "ckpt")
    cfg = ConvTrainerConfig(workload="cnn", total_steps=4, backend="cuda",
                            ckpt_dir=ckpt_dir, ckpt_every=2, batch=8)

    def lose_host(step):
        if step == 2:
            raise ft.HostFailure(step, [1])

    try:
        ConvTrainer(cfg, mesh=mesh, device="cpu").run(fail_hook=lose_host)
        raise AssertionError("the host failure did not stop the run")
    except ft.HostFailure as e:
        lost = e.hosts
    ranks = ft.survivors(mesh, lost, devices_per_host=2)
    small = ft.elastic_mesh(ranks, model_parallel=2, device="cpu")
    if rank in ranks:
        res = ConvTrainer(cfg, mesh=small, device="cpu").run()
        out["elastic"] = {"ranks": ranks, "shape": tuple(small.shape),
                          "names": small.mesh_dim_names,
                          "start": res["start_step"],
                          "history": [h["step"] for h in res["history"]],
                          "state": _whole(res["state"])}
    if rank == 0:
        alone = ConvTrainer(ConvTrainerConfig(
            workload="cnn", total_steps=4, backend="cuda", batch=8),
            device="cpu").run()
        out["alone"] = alone["state"]


def worker(rank: int, tmp: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=WORLD)
    try:
        _guard_dtensor_collectives()
        from repro_torch.launch.mesh import make_debug_mesh
        mesh = make_debug_mesh((2, 2), ("data", "model"), device="cpu")
        inp = dict(np.load(os.path.join(tmp, "inputs.npz")))
        out = {"coord": (mesh.get_local_rank(0), mesh.get_local_rank(1))}
        _steps(mesh, inp, out)
        _one_layer(mesh, inp, out)
        _elastic(mesh, rank, tmp, out)
        torch.save(out, os.path.join(tmp, f"results_{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def start(tmp: str):
    """Spawn the ranks and return at once (the caller works meanwhile)."""
    import torch.multiprocessing as mp
    return mp.spawn(worker, args=(tmp,), nprocs=WORLD, join=False)


def finish(ctx, tmp: str) -> list:
    """Wait for the ranks (a rank's failure raises here); every rank's
    results, by rank."""
    while not ctx.join():
        pass
    return [torch.load(os.path.join(tmp, f"results_{r}.pt"),
                       weights_only=False) for r in range(WORLD)]


def card_worker(rank: int, tmp: str, shape: tuple):
    """A rank of `test_torch_cuda.py`'s 2-rank check: the CNN `sgd_step`
    on a `shape` mesh on the card (`cuda` backend), against the same step
    on this rank alone; writes whether each param is within rtol 2e-4 /
    atol 2e-5, the loss's difference and the sharded step's launches."""
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import cnn
    from repro_torch.models.layers import tree_leaves
    from repro_torch.parallel import sharding as sh
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=2)
    try:
        _guard_dtensor_collectives()
        mesh = make_debug_mesh(shape, ("data", "model"))
        dev = torch.device("cuda")
        g = torch.Generator().manual_seed(0)
        params = cnn.simple_cnn_init(g, widths=(16, 32), device=dev)
        x = torch.randn((8, 16, 16, 3), generator=g).to(dev)
        labels = torch.randint(0, 10, (8,), generator=g).to(dev)
        want, want_loss = cnn.sgd_step(params, x, labels, backend="cuda")
        with sh.use_mesh(mesh):
            ops.reset_launches()
            got, loss = cnn.sgd_step(_put(params, mesh), _batch(x, mesh),
                                     _batch(labels, mesh), backend="cuda")
            torch.cuda.synchronize()
            launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        got = _whole(got)
        torch.save({"launches": launches,
                    "loss_err": abs(loss.item() - want_loss.item()),
                    "close": [torch.allclose(a, b, rtol=2e-4, atol=2e-5)
                              for a, b in zip(tree_leaves(got),
                                              tree_leaves(want))]},
                   os.path.join(tmp, f"card_{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
