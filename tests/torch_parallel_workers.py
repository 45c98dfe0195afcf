"""Rank functions for the mesh tests (``tests/test_torch_parallel.py``),
spawned by ``parallel.launch``: this module imports torch, numpy and the
port only, never JAX, so a spawned rank stays free of it. Inputs arrive as
numpy trees made in the parent (from the JAX package's draws where a test
holds the port to it); each function builds its meshes over the running
process group (gloo, CPU) and returns numpy results."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from autostyle_tts_tpu_torch.models import cfm, token_lm
from autostyle_tts_tpu_torch.models import transformer as core
from autostyle_tts_tpu_torch.ops.sampling import SamplerConfig
from autostyle_tts_tpu_torch.parallel import comm
from autostyle_tts_tpu_torch.parallel.mesh import make_mesh
from autostyle_tts_tpu_torch.parallel.sharding import abstract, batch_sharding, gather_params, shard_params
from autostyle_tts_tpu_torch.pipeline.engine import Engine
from autostyle_tts_tpu_torch.train import lora_sft
from autostyle_tts_tpu_torch.train.optim import tree_leaves
from autostyle_tts_tpu_torch.utils.checkpoint import CheckpointManager
from autostyle_tts_tpu_torch.utils.config import TrainConfig, TransformerConfig, tiny_config
from autostyle_tts_tpu_torch.weights import tree_from_numpy, tree_map


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _tensors(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _engine_batch(case, mesh):
    """The mesh engine's batch -> (wavs, the data axis, each span of its
    trace as (name, collectives, collective_ms))."""
    cfg = tiny_config()
    eng = Engine(cfg, seed=case["seed"], device="cpu", mesh=mesh)
    wavs = eng.synthesize_batch(case["texts"], case["styles"], case["sty"], case["tim"])
    coll = [(s.name, s.counters.get("collectives", 0), s.counters.get("collective_ms", 0.0)) for s in eng.last_trace]
    return wavs, eng.dp, coll


def _decode_span(case, mesh):
    """(attributes, counters) of the decode span of the mesh engine's batch."""
    eng = Engine(tiny_config(), seed=case["seed"], device="cpu", mesh=mesh)
    eng.synthesize_batch(case["texts"], case["styles"], case["sty"], case["tim"])
    dec = [s for s in eng.last_trace if s.name == "decode"][0]
    return dict(dec.attrs), dict(dec.counters)


def eight_ranks(emb, gen, flow, eng):
    """The 8-rank contracts of ``tests/test_multichip.py``: the TP embed at
    dp 2 x tp 4, the greedy generate at dp 8, the CFM sample at dp 4 x tp
    2, the engine at dp 2 x tp 4."""
    out = {}
    mesh = make_mesh(2, 4, device="cpu")
    ecfg = TransformerConfig(**emb["cfg"])
    params = shard_params(mesh, tree_from_numpy(emb["params"]), (ecfg.n_heads, ecfg.n_kv_heads))
    toks, mask = _tensors(emb["tokens"], emb["mask"])
    rows = batch_sharding(mesh, toks.shape[0])
    with mesh:
        out["embed"] = comm.gather_rows(core.embed_text(params, ecfg, toks[rows], mask[rows])).numpy()

    mesh = make_mesh(8, 1, device="cpu")
    lcfg = dataclasses.replace(tiny_config().token_lm)
    lm = shard_params(mesh, tree_from_numpy(gen["params"]), (lcfg.n_heads, lcfg.n_kv_heads))
    inputs = _tensors(*gen["inputs"])
    rows = batch_sharding(mesh, inputs[0].shape[0])
    with mesh:
        g = token_lm.generate_speech_from_ids(lm, lcfg, *(x[rows] for x in inputs), None,
                                              max_new_tokens=gen["max_new"], sampler=SamplerConfig.label())
        out["generate"] = comm.gather_rows(g.tokens).numpy()

    mesh = make_mesh(4, 2, device="cpu")
    c = dataclasses.replace(tiny_config().cfm)
    fp = shard_params(mesh, tree_from_numpy(flow["params"]), (c.n_heads, c.n_heads))
    tokens, noise = _tensors(flow["tokens"], flow["noise"])
    B, F = noise.shape[:2]
    rows = batch_sharding(mesh, B)
    n = rows.stop - rows.start
    with mesh:
        cond = cfm.upsample_tokens(fp, tokens[rows], c.upsample, c.token_vocab_size)
        mel = cfm.sample_mel(fp, c, None, cond, torch.ones((n, c.spk_dim)), torch.zeros((n, F, c.n_mels)),
                             torch.zeros((n, F)), torch.ones((n, F)), use_cfg=True, noise=noise[rows])
        out["cfm"] = comm.gather_rows(mel).numpy()

    out["engine"], out["engine_dp"], _ = _engine_batch(eng, make_mesh(2, 4, device="cpu"))
    return out


def four_ranks(eng, ragged, sft, tmp):
    """The 4-rank contracts: the engine at dp 4, a ragged batch of 3 at dp
    4, the decode span of a batch at dp 2 x tp 2, the SFT step at dp 2 x
    tp 2 (loss, updated LoRA), shard_params -> gather_params, the dcp
    checkpoint saved at tp 2 and restored at tp 1, tp 2 and tp 4."""
    out = {}
    out["engine"], out["engine_dp"], out["engine_collectives"] = _engine_batch(eng, make_mesh(4, 1, device="cpu"))
    out["ragged"], _, _ = _engine_batch(ragged, make_mesh(4, 1, device="cpu"))
    out["tp2_decode"] = _decode_span(ragged, make_mesh(2, 2, device="cpu"))

    mesh = make_mesh(2, 2, device="cpu")
    cfg, tcfg = TransformerConfig(**sft["cfg"]), TrainConfig(**sft["tcfg"])
    heads = (cfg.n_heads, cfg.n_kv_heads)
    params, lora = tree_from_numpy(sft["params"]), tree_from_numpy(sft["lora"])
    p_sh, l_sh = shard_params(mesh, params, heads), shard_params(mesh, lora, heads)
    out["round_trip"] = all(bool(torch.equal(a, b)) for a, b in zip(
        tree_leaves(gather_params(mesh, l_sh, like=lora, heads=heads)), tree_leaves(lora)))
    opt = lora_sft.make_optimizer(tcfg, 10)
    step = lora_sft.make_train_step(cfg, tcfg, opt, packed=sft["packed"], mesh=mesh)
    batch = _tensors(*sft["batch"])
    opt_state = opt.init(l_sh)
    l2, opt_state, loss = step(l_sh, opt_state, p_sh, *batch, None, noise=torch.as_tensor(sft["noise"]))
    out["sft_loss"] = float(loss)
    out["sft_lora"] = _numpy(gather_params(mesh, l2, like=lora, heads=heads))
    out["sft_grad_norm"] = float(step.grad_norm)

    state = {"lora": l2, "opt_state": opt_state}
    full_like = {"lora": abstract(lora), "opt_state": abstract(opt.init(abstract(lora)))}
    mgr = CheckpointManager(tmp, backend="dcp")
    with mesh:
        mgr.save(1, state, metadata={"best_f1": 0.5}, like=full_like, heads=heads)
    full_state = gather_params(mesh, state, like=full_like, heads=heads)
    for name, (d, m) in (("tp1", (4, 1)), ("tp2", (2, 2)), ("tp4", (1, 4))):
        target = make_mesh(d, m, device="cpu")
        want = shard_params(target, full_state, heads)
        with target:
            got = mgr.restore(tree_map(torch.zeros_like, want), heads=heads)
        out[f"restore_{name}"] = all(bool(torch.equal(a, b)) for a, b in zip(tree_leaves(got),
                                                                             tree_leaves(want)))
    return out


def embed_on_card(cfg_kw, tokens):
    """The GPU test's TP embed: this rank's slices of an embedder drawn
    from ``PRNGKey(0)`` on the card, the batch embedded at tp = world size
    (ranks sharing the card, gloo) -> (the embed, this rank's flash
    launches)."""
    from autostyle_tts_tpu_torch.ops import flash_attn
    from autostyle_tts_tpu_torch.utils import rng

    world = torch.distributed.get_world_size()
    mesh = make_mesh(1, world, device="cuda", backend="gloo")
    cfg = TransformerConfig(**cfg_kw)
    params = shard_params(mesh, core.init_params(cfg, rng.PRNGKey(0, mesh.device)), (cfg.n_heads, cfg.n_kv_heads))
    toks = torch.as_tensor(tokens, device=mesh.device)
    flash_attn.flash_attention.launches = 0
    with torch.no_grad(), mesh:
        out = core.embed_text(params, cfg, toks, torch.ones_like(toks))
    return out.cpu().numpy(), flash_attn.flash_attention.launches


def engine_on_card(case):
    """The GPU test's engine at dp = world size on the card (gloo) -> the
    wavs."""
    mesh = make_mesh(torch.distributed.get_world_size(), 1, device="cuda", backend="gloo")
    eng = Engine(tiny_config(), seed=case["seed"], mesh=mesh)
    return eng.synthesize_batch(case["texts"], case["styles"], case["sty"], case["tim"])
