"""The rank side of `test_torch_mesh_families.py`: one spawn of 4 `gloo`
CPU ranks on a (2, 2) ("data", "model") mesh runs every LM family of the
port on the mesh and writes what it saw.

Each rank joins a process group through a `file://` store in the test's
temporary directory, with DTensor's own collectives made to raise
(`_torch_mesh._guard_dtensor_collectives`), and runs on the numpy inputs
the test pickled to `inputs.pkl`, for each case (a SMOKE config in fp32)
and each of its layouts ("train", "tp" = the serve layout, "ffn" =
`moe_ffn_data`): the loss and every gradient (`steps.loss_and_grads`),
the prefill and each forced decode (the logits and the whole cache after
each call), and for the cases that ask, one `make_train_step` step's
metrics and `ServeEngine(mesh=, serve_sharding="tp")`'s tokens.  Each
rank writes `results_<rank>.pt`.
"""
from __future__ import annotations

import os
import pickle

import torch
import torch.distributed as dist

WORLD = 4
LAYOUTS = {"train": {}, "tp": {"serve": True}, "ffn": {"moe_ffn_data": True}}


def _whole(tree):
    from repro_torch.models.layers import tree_map
    from repro_torch.parallel import sharding as sh
    return tree_map(lambda t: sh.full_tensor(t).detach().clone()
                    if torch.is_tensor(t) or sh.is_container(t) else t, tree)


def _case(mesh, case):
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import steps
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.layers import tree_map
    from repro_torch.models.lm import LM
    from repro_torch.optim.optimizer import AdamWConfig, adamw_init
    from repro_torch.parallel import sharding as sh
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = ModelConfig(**case["cfg"])
    lm = LM(cfg)
    params = params_from_numpy(case["params"], device="cpu")
    inputs, labels, prompts = (torch.from_numpy(case[k])
                               for k in ("inputs", "labels", "prompts"))
    forced = torch.from_numpy(case["forced"])
    out = {}
    for layout in case["layouts"]:
        ps = sh.device_put(params, sh.tree_shardings(params, mesh,
                                                     **LAYOUTS[layout]))
        P = tree_map(lambda t: sh.as_sharded(t, mesh), ps)
        (loss, aux), grads = steps.loss_and_grads(lm, P, inputs, labels)
        res = {"loss": loss.item(), "aux": {k: v.item()
                                            for k, v in aux.items()},
               "grads": tree_map(lambda g, p: sh.full_tensor(
                   sh.Sharded(g, mesh, p.spec)), grads, P)}
        with torch.no_grad():
            logits, cache = lm.prefill(ps, prompts, case["max_len"])
            calls = [(logits.clone(), _whole(cache))]
            for t in range(forced.shape[1]):
                logits, cache = lm.decode_step(ps, cache, forced[:, t:t + 1])
                calls.append((logits.clone(), _whole(cache)))
        res["calls"] = calls
        res["cache_specs"] = {k: v.spec for k, v in cache.items()
                              if k != "len"}
        if case.get("step") and layout == "train":
            ocfg = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=4)
            opt = sh.device_put(adamw_init(params, ocfg), sh.tree_shardings(
                adamw_init(params, ocfg), mesh))
            batch = {k: sh.device_put(v, sh.NamedSharding(mesh, sh.batch_pspec(
                mesh, v.dim(), 0, v.shape[0])))
                for k, v in (("inputs", inputs), ("labels", labels))}
            _, _, m = steps.make_train_step(cfg, ocfg)(ps, opt, batch)
            res["step"] = {k: float(v) for k, v in m.items()}
        out[layout] = res
    if case.get("engine"):
        eng = ServeEngine(cfg, params, batch=2, max_len=case["max_len"],
                          device="cpu", mesh=mesh, serve_sharding="tp")
        reqs = [Request(uid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(case["engine"])]
        out["engine"] = {"tokens": eng.generate(reqs),
                         "stats": dict(eng.stats)}
    return out


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
        for name, case in inp.items():
            out[name] = _case(mesh, case)
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


def card_worker(rank: int, tmp: str, arch: str):
    """A rank of `test_torch_cuda.py`'s 2-rank family check on the card:
    a (1, 2) ("data", "model") mesh of `gloo` ranks sharing it, `arch`'s
    SMOKE config in fp32: the loss, the MoE aux and every gradient in the
    training layout, then the prefill of 5 tokens and 6 forced decodes in
    the serve layout, each against the same call on this rank alone;
    writes the largest differences and the launches."""
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
        cfg = get_smoke_config(arch).scaled(dtype="float32")
        lm = LM(cfg)
        params = lm.init(torch.Generator().manual_seed(0), device=dev)
        g = torch.Generator().manual_seed(1)
        labels = torch.randint(0, cfg.vocab, (4, 32), generator=g).to(dev)
        inputs = torch.randint(0, cfg.vocab, (4, 32), generator=g).to(dev)
        toks = torch.randint(1, cfg.vocab, (2, 5), generator=g).to(dev)
        forced = torch.randint(1, cfg.vocab, (2, 6), generator=g).to(dev)
        out = {}
        (w_loss, w_aux), w_grads = steps.loss_and_grads(lm, params, inputs,
                                                        labels)
        P = tree_map(lambda t: sh.as_sharded(t, mesh), sh.device_put(
            params, sh.tree_shardings(params, mesh)))
        ops.reset_launches()
        (loss, aux), grads = steps.loss_and_grads(lm, P, inputs, labels)
        torch.cuda.synchronize()
        out["train_launches"] = {k: v for k, v in ops.LAUNCHES.items() if v}
        out["loss_err"] = abs(loss.item() - w_loss.item()) / abs(
            w_loss.item())
        out["aux_err"] = abs(aux["aux"].item() - w_aux["aux"].item()) / max(
            abs(w_aux["aux"].item()), 1e-30)
        out["grad_err"] = max(
            ((sh.full_tensor(sh.Sharded(a, mesh, p.spec)) - b).abs().max()
             / b.abs().max().clamp_min(1e-30)).item()
            for a, p, b in zip(tree_leaves(grads), tree_leaves(P),
                               tree_leaves(w_grads)))
        out["launches"], out["logits_err"], out["cache_err"] = [], 0.0, 0.0
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
                out["cache_err"] = max([out["cache_err"]] + [
                    (sh.full_tensor(c) - want[1][k]).abs().max().item()
                    for k, c in got[1].items() if k != "len"])
                if i == forced.shape[1]:
                    break
                tok = forced[:, i:i + 1]
                want = lm.decode_step(params, want[1], tok)
                ops.reset_launches()
                got = lm.decode_step(sp, got[1], tok)
        torch.save(out, os.path.join(tmp, f"card_{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()
