"""The rank side of `test_torch_mesh_lm.py`: one spawn of 4 `gloo` CPU
ranks runs every sharded LM check of the port and writes what it saw.

Each rank joins a process group through a `file://` store in the test's
temporary directory, with DTensor's own collectives made to raise
(`_torch_mesh._guard_dtensor_collectives`), and runs on the numpy inputs
the test pickled to `inputs.pkl`:
  * on a (2, 2) ("data", "model") mesh: `make_train_step` (n_micro 1 and
    2) on qwen3-0.6b's SMOKE params laid out by `tree_shardings`, the
    batch by `batch_pspec`, and the loss and gradients alone; prefill and
    8 forced decode steps in the training and the serve ("tp") layout;
    `ServeEngine(mesh=)` in both layouts on qwen2-1.5b's untied SMOKE
    params; the serve layout's block of each param; the shapes every
    attention call was given;
  * `Trainer(mesh=)` restoring `repro`'s step-2 checkpoint onto the
    elastic (1, 2) mesh left after host 1 (ranks 2, 3) is lost, and
    running it to step 4;
  * `gpipe` over a 4-stage ("stage",) mesh; `compressed_psum` over a
    (2, 2) ("pod", "data") mesh;
  * last (it re-forms the group): `RunSupervisor` on the cnn workload
    with host 1 lost at step 3, and rank 0's fault-free run.
Each rank writes `results_<rank>.pt`.
"""
from __future__ import annotations

import os
import pickle
import shutil
import time

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4


def _whole(tree):
    from repro_torch.models.layers import tree_map
    from repro_torch.parallel import sharding as sh
    return tree_map(lambda t: sh.full_tensor(t).detach().clone()
                    if torch.is_tensor(t) or sh.is_container(t) else t, tree)


def _put_batch(a, mesh):
    from repro_torch.parallel import sharding as sh
    return sh.device_put(a, sh.NamedSharding(
        mesh, sh.batch_pspec(mesh, a.dim(), 0, a.shape[0])))


def _cfg(fields):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**fields)


def _spy_attention(seen):
    """Record the (q, k) shapes of every `ops.flash_attention` call."""
    from repro_torch.kernels import ops
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), kw.get("return_lse",
                                                             False)))
        return real(q, k, v, **kw)
    ops.flash_attention = spy
    return real


def _train(mesh, inp, out):
    from repro_torch.convert import params_from_numpy
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.lm import LM
    from repro_torch.optim.optimizer import AdamWConfig, adamw_init
    from repro_torch.parallel import sharding as sh
    cfg = _cfg(inp["cfg"])
    ocfg = AdamWConfig(**inp["opt"])
    params = params_from_numpy(inp["params"], device="cpu")
    inputs, labels = (torch.from_numpy(inp[k]) for k in ("inputs", "labels"))
    batch = {"inputs": _put_batch(inputs, mesh),
             "labels": _put_batch(labels, mesh)}
    ps = sh.device_put(params, sh.tree_shardings(params, mesh))
    for n_micro in (1, 2):
        opt = adamw_init(params, ocfg)
        os_ = sh.device_put(opt, sh.tree_shardings(opt, mesh))
        seen = []
        real = _spy_attention(seen)
        try:
            p2, o2, m = steps.make_train_step(cfg, ocfg, n_micro)(
                ps, os_, batch)
        finally:
            ops.flash_attention = real
        out[f"step_{n_micro}"] = {
            "params": _whole(p2), "opt": _whole(o2),
            "metrics": {k: float(v) for k, v in m.items()},
            "placements": sorted({str(t.placements)
                                  for t in tree_leaves(p2)}),
            "attention": seen}
    with torch.no_grad():
        out["forward"] = LM(cfg).forward(ps, batch["inputs"])[0]
    P = tree_map(lambda t: sh.as_sharded(t, mesh), ps)
    (loss, aux), grads = steps.loss_and_grads(LM(cfg), P, inputs, labels)
    out["grads"] = {"loss": loss.item(), "nll": aux["nll"].item(),
                    "grads": tree_map(lambda g, p: sh.full_tensor(
                        sh.Sharded(g, mesh, p.spec)), grads, P)}


def _serve(mesh, inp, out):
    from repro_torch.convert import params_from_numpy
    from repro_torch.kernels import ops
    from repro_torch.models.layers import tree_map
    from repro_torch.models.lm import LM
    from repro_torch.parallel import sharding as sh
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = _cfg(inp["cfg"])
    lm = LM(cfg)
    params = params_from_numpy(inp["params"], device="cpu")
    prompts = torch.from_numpy(inp["prompts"])
    forced = torch.from_numpy(inp["forced"])
    ecfg = _cfg(inp["engine_cfg"])
    eparams = params_from_numpy(inp["engine_params"], device="cpu")
    for layout in ("train", "tp"):
        ps = sh.device_put(params, sh.tree_shardings(
            params, mesh, serve=layout == "tp"))
        seen = []
        real = _spy_attention(seen)
        try:
            with torch.no_grad():
                logits, cache = lm.prefill(ps, _put_batch(prompts, mesh),
                                           inp["max_len"])
                calls = [(logits.clone(), _whole(cache["k"]),
                          _whole(cache["v"]))]
                for t in range(forced.shape[1]):
                    logits, cache = lm.decode_step(ps, cache,
                                                   forced[:, t:t + 1])
                    calls.append((logits.clone(), _whole(cache["k"]),
                                  _whole(cache["v"])))
        finally:
            ops.flash_attention = real
        blocks = tree_map(lambda t: sh.as_sharded(t, mesh).local.clone(),
                          sh.device_put(inp["arange"], sh.tree_shardings(
                              inp["arange"], mesh, serve=True)))
        eng = ServeEngine(ecfg, eparams, batch=2, max_len=48, device="cpu",
                          mesh=mesh, serve_sharding=layout)
        reqs = [Request(uid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(inp["engine_prompts"],
                                               inp["engine_budgets"]))]
        out[f"serve_{layout}"] = {
            "calls": calls, "attention": seen,
            "cache_spec": cache["k"].spec,
            "cache_block": tuple(cache["k"].local.shape),
            "tokens": eng.generate(reqs), "stats": dict(eng.stats),
            "serve_blocks": blocks}


def _trainer(mesh, rank, tmp, inp, out):
    from repro_torch.data.pipeline import TokenDataset
    from repro_torch.optim.optimizer import AdamWConfig
    from repro_torch.train import fault_tolerance as ft
    from repro_torch.train.trainer import Trainer, TrainerConfig
    ranks = ft.survivors(mesh, [1], devices_per_host=2)
    small = ft.elastic_mesh(ranks, model_parallel=2, device="cpu")
    if rank not in ranks:
        return
    t = inp["trainer"]
    d = os.path.join(tmp, "port_ckpt")
    if rank == ranks[0]:
        os.makedirs(d)
        shutil.copytree(os.path.join(tmp, "repro_ckpt", "step_2"),
                        os.path.join(d, "step_2"))
        with open(os.path.join(d, "LATEST"), "w") as f:
            f.write("2")
    dist.barrier(group=small.get_group("model"))
    ds = TokenDataset(vocab=t["vocab"], seq_len=t["seq_len"],
                      global_batch=t["batch"], seed=0)
    trainer = Trainer(_cfg(t["cfg"]), ds, AdamWConfig(**t["opt"]),
                      TrainerConfig(total_steps=4, ckpt_dir=d, ckpt_every=2,
                                    log_every=1, async_checkpoint=False),
                      mesh=small, device="cpu")
    params, opt, step = trainer.maybe_restore()
    restored = {"params": _whole(params), "opt": _whole(opt), "step": step}
    res = trainer.run()
    out["trainer"] = {"ranks": ranks, "shape": tuple(small.shape),
                      "restored": restored, "history": res["history"],
                      "params": _whole(res["params"])}


def _pipeline(inp, out):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.pipeline import gpipe
    mesh = make_mesh(range(WORLD), (WORLD,), ("stage",), device="cpu")
    ws, x = torch.from_numpy(inp["gp_w"]), torch.from_numpy(inp["gp_x"])

    def stage_fn(w, h):
        return torch.tanh(h @ w)

    out["gpipe"] = gpipe(mesh, "stage", stage_fn, ws, x, x.shape[0])
    split = sh.device_put(ws, sh.NamedSharding(mesh, ("stage", None, None)))
    out["gpipe_split"] = gpipe(mesh, "stage", stage_fn, split, x,
                               x.shape[0])


def _compression(inp, out):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.compression import (
        compressed_psum, make_compressed_grad_allreduce)
    mesh = make_mesh(range(WORLD), (2, 2), ("pod", "data"), device="cpu")
    pod = mesh.get_local_rank("pod")
    g = torch.from_numpy(inp["cp_g"][pod])
    out["compressed"] = compressed_psum(g, mesh, "pod", torch.zeros_like(g))
    f = make_compressed_grad_allreduce(mesh, "pod")
    out["compressed_tree"] = f({"a": g, "b": [2 * g[:8]]},
                               {"a": torch.zeros_like(g),
                                "b": [torch.zeros(8)]})


def _supervisor(rank, tmp, out):
    from repro_torch.models.layers import tree_map
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.conv_trainer import ConvTrainer, ConvTrainerConfig
    from repro_torch.train.supervisor import RunSupervisor
    cfg = dict(workload="cnn", total_steps=6, widths=[4], image=8,
               n_classes=4, batch=8, backend="cuda", ckpt_every=2, seed=0)
    rdv = os.path.join(tmp, "rendezvous")
    os.makedirs(rdv, exist_ok=True)
    sup = RunSupervisor(ConvTrainerConfig(**cfg, ckpt_dir=os.path.join(
        tmp, "sup_ckpt")), rendezvous=rdv, devices_per_host=2,
        model_parallel=2, host_schedule={3: [1]}, device="cpu")
    res = sup.run()
    if res.get("lost"):
        out["supervisor"] = {"lost": True, "report": res["report"],
                             "group": dist.is_initialized()}
        return
    out["supervisor"] = {
        "lost": False, "report": res["report"],
        "history": [h["step"] for h in res["history"]],
        "state": tree_map(lambda t: sh.full_tensor(t).clone(),
                          res["state"]),
        "world": dist.get_world_size()}
    if rank == 0:
        out["fault_free"] = ConvTrainer(ConvTrainerConfig(**cfg),
                                        device="cpu").run()["state"]


def worker(rank: int, tmp: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=WORLD)
    try:
        import _torch_mesh
        _torch_mesh._guard_dtensor_collectives()
        from repro_torch.launch.mesh import make_debug_mesh
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        mesh = make_debug_mesh((2, 2), ("data", "model"), device="cpu")
        out = {"coord": (mesh.get_local_rank(0), mesh.get_local_rank(1))}
        _train(mesh, inp, out)
        _serve(mesh, inp, out)
        _pipeline(inp, out)
        _compression(inp, out)
        ready = os.path.join(tmp, "repro_ckpt", "READY")
        deadline = time.monotonic() + 300
        while not os.path.exists(ready):     # the test writes it meanwhile
            if time.monotonic() > deadline:
                raise TimeoutError("repro's checkpoint never came")
            time.sleep(0.05)
        _trainer(mesh, rank, tmp, inp, out)
        dist.barrier()
        _supervisor(rank, tmp, out)
        torch.save(out, os.path.join(tmp, f"results_{rank}.pt"))
    finally:
        if dist.is_initialized():
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


def card_worker(rank: int, tmp: str):
    """A rank of `test_torch_cuda.py`'s 2-rank LM check on the card: a
    (1, 2) ("data", "model") mesh of `gloo` ranks sharing it.  qwen3's
    SMOKE config in fp32 with a 16-position cache: the prefill of 5
    tokens and 6 forced decodes in the serve layout (the second sequence
    block gets its first key at the 4th decode), and the loss and
    gradients in the training layout, each against the same call on this
    rank alone; writes the largest differences and the launches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.lm import LM
    from repro_torch.parallel import sharding as sh
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=2)
    try:
        import _torch_mesh
        _torch_mesh._guard_dtensor_collectives()
        mesh = make_debug_mesh((1, 2), ("data", "model"))
        dev = torch.device("cuda")
        cfg = get_smoke_config("qwen3-0.6b").scaled(dtype="float32")
        lm = LM(cfg)
        params = lm.init(torch.Generator().manual_seed(0), device=dev)
        g = torch.Generator().manual_seed(1)
        toks = torch.randint(1, cfg.vocab, (2, 5), generator=g).to(dev)
        forced = torch.randint(1, cfg.vocab, (2, 6), generator=g).to(dev)
        out = {"launches": [], "logits_err": 0.0}
        with torch.no_grad():
            sp = sh.device_put(params, sh.tree_shardings(params, mesh,
                                                         serve=True))
            want = lm.prefill(params, toks, 16)
            ops.reset_launches()
            got = lm.prefill(sp, toks, 16)
            for i in range(forced.shape[1] + 1):
                torch.cuda.synchronize()
                out["launches"].append(ops.LAUNCHES["flash_attention"])
                out["logits_err"] = max(out["logits_err"], (
                    got[0] - want[0]).abs().max().item())
                if i == forced.shape[1]:
                    break
                tok = forced[:, i:i + 1]
                want = lm.decode_step(params, want[1], tok)
                ops.reset_launches()
                got = lm.decode_step(sp, got[1], tok)
        labels = torch.randint(0, cfg.vocab, (4, 32), generator=g).to(dev)
        inputs = torch.randint(0, cfg.vocab, (4, 32), generator=g).to(dev)
        (w_loss, _), w_grads = steps.loss_and_grads(lm, params, inputs,
                                                    labels)
        P = tree_map(lambda t: sh.as_sharded(t, mesh), sh.device_put(
            params, sh.tree_shardings(params, mesh)))
        ops.reset_launches()
        (loss, _), grads = steps.loss_and_grads(lm, P, inputs, labels)
        torch.cuda.synchronize()
        out["train_launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
        out["loss_err"] = abs(loss.item() - w_loss.item()) / abs(
            w_loss.item())
        out["grad_errs"] = [
            ((sh.full_tensor(sh.Sharded(a, mesh, p.spec)) - b).abs().max()
             / b.abs().max().clamp_min(1e-30)).item()
            for a, p, b in zip(tree_leaves(grads), tree_leaves(P),
                               tree_leaves(w_grads))]
        out["grad_err"] = max(out["grad_errs"])
        torch.save(out, os.path.join(tmp, f"card_{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
