"""The port's device mesh over spawned gloo ranks on the CPU: the
counterparts of ``tests/test_multichip.py`` (the tensor-parallel embed,
the data-parallel generate, the CFM sample, the engine at dp 4 and at
dp 2 x tp 4, a ragged batch), the SFT step at dp 2 x tp 2, the
``shard_params`` / ``gather_params`` round trip, the ``dcp`` checkpoint
across mesh shapes and both dry runs.

Two launches (``parallel.launch``: 8 ranks, then 4) run every multi-rank
case once, in ``tests/torch_parallel_workers.py`` (torch only: no rank
imports JAX); the JAX references and the unsharded port runs are made here,
in the parent. Tolerances: the embed 2e-4 (the JAX test's), the CFM 1e-5
against the unsharded port and against JAX, the engine's wavs 1e-4 at dp 4
and 2e-4 at dp 2 x tp 4 (the JAX tests'), the SFT step 1e-5; greedy
tokens, the round trip and the restored checkpoints exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autostyle_tts_tpu.models import cfm as jcfm
from autostyle_tts_tpu.models import frontend as jfrontend
from autostyle_tts_tpu.models import token_lm as jlm
from autostyle_tts_tpu.models import transformer as jtransformer
from autostyle_tts_tpu.ops.sampling import SamplerConfig as JSampler
from autostyle_tts_tpu.train import lora_sft as jsft
from autostyle_tts_tpu.utils import config as jconfig
from autostyle_tts_tpu_torch.models import cfm as tcfm
from autostyle_tts_tpu_torch.models import token_lm as tlm
from autostyle_tts_tpu_torch.ops.sampling import SamplerConfig
from autostyle_tts_tpu_torch.ops.sampling import sample as tsample
from autostyle_tts_tpu_torch.parallel.launch import launch
from autostyle_tts_tpu_torch.pipeline.engine import Engine, dryrun_engine
from autostyle_tts_tpu_torch.train import lora_sft as tsft
from autostyle_tts_tpu_torch.utils.checkpoint import CheckpointManager
from autostyle_tts_tpu_torch.utils.config import TrainConfig, TransformerConfig, tiny_config
from autostyle_tts_tpu_torch.weights import tree_from_numpy

import torch_parallel_workers as workers
from torch_one_thread import one_thread  # noqa: F401

NP = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731


def _wavs(seed, freqs_sty, freqs_tim, n):
    sr = tiny_config().audio.prompt_sample_rate
    t = np.arange(sr) / sr
    r = np.random.default_rng(seed)
    mk = lambda f: (0.3 * np.sin(2 * np.pi * f * t) + 0.02 * r.standard_normal(t.size)).astype(np.float32)  # noqa: E731
    return [mk(f) for f in freqs_sty[:n]], [mk(f) for f in freqs_tim[:n]]


def _embed_case():
    cfg = jconfig.TransformerConfig(vocab_size=jfrontend.VOCAB_SIZE, dim=64, n_layers=2, n_heads=8, n_kv_heads=4,
                                    ffn_dim=128, max_seq_len=64, dtype="float32")
    params = jtransformer.init_params(jax.random.PRNGKey(0), cfg)
    toks = np.random.default_rng(0).integers(16, 272, (4, 12)).astype(np.int32)
    mask = np.ones((4, 12), np.int32)
    want = np.asarray(jtransformer.embed_text(params, cfg, jnp.asarray(toks), jnp.asarray(mask)))
    return {"cfg": dataclasses.asdict(cfg), "params": NP(params), "tokens": toks, "mask": mask}, want


def _generate_case(monkeypatch):
    cfg = jconfig.tiny_config().token_lm
    params = jlm.init_params(jax.random.PRNGKey(0), cfg)
    B = 8
    r = np.random.default_rng(0)
    inputs = (r.integers(16, 200, (B, 8)).astype(np.int32), np.full((B,), 8, np.int32),
              r.integers(0, 64, (B, 4)).astype(np.int32), np.full((B,), 4, np.int32),
              r.standard_normal((B, cfg.spk_dim)).astype(np.float32))
    # the prefill under the flash kernel, as the port's; traces made so must not outlive the test
    traced = (jlm.generate_speech_from_ids, jlm.generate_speech)
    monkeypatch.setattr(jtransformer, "flash_ok", lambda t, hd: True)
    for fn in traced:
        fn.clear_cache()
    try:
        want = np.asarray(jlm.generate_speech_from_ids(
            params, cfg, *map(jnp.asarray, inputs), jax.random.PRNGKey(0), max_new_tokens=8,
            sampler=JSampler(greedy=True), fused=False).tokens)
    finally:
        for fn in traced:
            fn.clear_cache()
    # the port's unsharded run, each step's masked logits recorded
    logits = []
    monkeypatch.setattr(tlm, "sample", lambda lg, cfg, gen, **kw: logits.append(lg.clone()) or tsample(lg, cfg, gen))
    got = tlm.generate_speech_from_ids(tree_from_numpy(NP(params)), tiny_config().token_lm,
                                       *map(torch.as_tensor, inputs), None, max_new_tokens=8,
                                       sampler=SamplerConfig.label()).tokens.numpy()
    monkeypatch.undo()
    return {"params": NP(params), "inputs": inputs, "max_new": 8}, want, got, torch.stack(logits, 1).numpy()


def _cfm_case():
    c = jconfig.tiny_config().cfm
    params = NP(jcfm.init_params(jax.random.PRNGKey(0), c))
    r = np.random.default_rng(0)        # fill the zero-initialized modulation and output so every layer counts
    params["layers"]["mod"] = (r.standard_normal(params["layers"]["mod"].shape) * 0.05).astype(np.float32)
    params["out_proj"] = (r.standard_normal(params["out_proj"].shape) * 0.1).astype(np.float32)
    B, T_tok = 8, 4
    F = T_tok * c.upsample
    tokens = np.ones((B, T_tok), np.int32)
    key = jax.random.PRNGKey(0)
    cond = jcfm.upsample_tokens(params, jnp.asarray(tokens), c.upsample)
    want = np.asarray(jcfm.sample_mel(params, c, key, cond, jnp.ones((B, c.spk_dim)), jnp.zeros((B, F, c.n_mels)),
                                      jnp.zeros((B, F)), jnp.ones((B, F)), use_cfg=True))
    noise = np.asarray(jax.random.normal(key, (B, F, c.n_mels), jnp.float32))
    tp = tree_from_numpy(params)
    unsharded = tcfm.sample_mel(tp, c, None, tcfm.upsample_tokens(tp, torch.as_tensor(tokens), c.upsample, c.token_vocab_size),
                                torch.ones((B, c.spk_dim)), torch.zeros((B, F, c.n_mels)), torch.zeros((B, F)),
                                torch.ones((B, F)), use_cfg=True, noise=torch.as_tensor(noise)).numpy()
    return {"params": params, "tokens": tokens, "noise": noise}, want, unsharded


def _engine_case(seed, texts, styles, wav_seed, f_sty, f_tim):
    sty, tim = _wavs(wav_seed, f_sty, f_tim, len(texts))
    case = {"seed": seed, "texts": texts, "styles": styles, "sty": sty, "tim": tim}
    ref = Engine(tiny_config(), seed=seed, device="cpu").synthesize_batch(texts, styles, sty, tim)
    return case, ref


def _sft_case():
    cfg = jconfig.TransformerConfig(vocab_size=jfrontend.VOCAB_SIZE, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                                    ffn_dim=128, max_seq_len=64, dtype="float32")
    tkw = dict(batch_size=4, grad_accum=1, max_seq_len=32, neftune_alpha=5.0, remat=False)
    tcfg = jconfig.TrainConfig(**tkw)
    params = NP(jtransformer.init_params(jax.random.PRNGKey(0), cfg))
    lora = NP(jtransformer.init_lora(jax.random.PRNGKey(1), cfg, tcfg.lora.r))
    r = np.random.default_rng(3)
    for name, b in list(lora["layers"].items()):   # a nonzero B gives every A a gradient
        if name.endswith("_lora_b"):
            lora["layers"][name] = (r.standard_normal(b.shape) * 0.02).astype(np.float32)
    B, T = tcfg.batch_size, tcfg.max_seq_len
    tokens = r.integers(16, 272, (B, T)).astype(np.int32)
    loss_mask = (r.random((B, T)) > 0.5).astype(np.int32)
    seg = np.zeros((B, T), np.int32)
    seg[:, : T // 2] = 1
    seg[:, T // 2 : T - 4] = 2
    loss_mask[:, T - 4 :] = 0
    key = jax.random.PRNGKey(2)
    jopt = jsft.make_optimizer(tcfg, 10)
    jstep = jsft.make_train_step(cfg, tcfg, jopt, packed=True)
    _, _, jloss = jstep(jax.tree_util.tree_map(jnp.asarray, lora), jopt.init(lora),
                        jax.tree_util.tree_map(jnp.asarray, params), *map(jnp.asarray, (tokens, loss_mask, seg)), key)
    noise = np.asarray(jax.random.uniform(key, (B, T, cfg.dim), jnp.float32, -1.0, 1.0))
    # the unsharded port step on the same inputs
    tcfg_t = TrainConfig(**tkw)
    cfg_t = TransformerConfig(**dataclasses.asdict(cfg))
    topt = tsft.make_optimizer(tcfg_t, 10)
    tlora = tree_from_numpy(lora)
    step = tsft.make_train_step(cfg_t, tcfg_t, topt, packed=True)
    l2, _, loss = step(tlora, topt.init(tlora), tree_from_numpy(params),
                       *map(torch.as_tensor, (tokens, loss_mask, seg)), None, noise=torch.as_tensor(noise))
    case = {"cfg": dataclasses.asdict(cfg), "tcfg": tkw, "params": params, "lora": lora,
            "batch": (tokens, loss_mask, seg), "noise": noise, "packed": True}
    return case, float(jloss), float(loss), l2, float(step.grad_norm)


@pytest.fixture(scope="module")
def eight(monkeypatch_module):
    emb, emb_want = _embed_case()
    gen, gen_want, gen_unsharded, gen_logits = _generate_case(monkeypatch_module)
    flow, cfm_want, cfm_unsharded = _cfm_case()
    eng, eng_ref = _engine_case(5, ["hello there", "general kenobi you are"], ["style a", "style b"], 11,
                                (210, 320), (190, 280))
    got = launch(workers.eight_ranks, 8, emb, gen, flow, eng, join_s=300)
    return dict(got=got, embed=emb_want, generate=gen_want, generate_unsharded=gen_unsharded,
                generate_logits=gen_logits, cfm=cfm_want, cfm_unsharded=cfm_unsharded, engine=eng_ref)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    eng, eng_ref = _engine_case(3, ["hello world", "the quick brown fox", "ok then", "more text here"],
                                ["style one", "style two", "style three", "style four"], 7,
                                (200, 250, 300, 350), (180, 220, 260, 320))
    sty, _ = _wavs(1, (200, 260, 330), (200, 260, 330), 3)
    ragged = {"seed": 1, "texts": ["a b c", "d e", "f"], "styles": ["s1", "s2", "s3"], "sty": sty, "tim": sty}
    sft, jloss, tloss, tlora, tnorm = _sft_case()
    got = launch(workers.four_ranks, 4, eng, ragged, sft, str(tmp_path_factory.mktemp("dcp")), join_s=300)
    return dict(got=got, engine=eng_ref, sft_jax_loss=jloss, sft_loss=tloss, sft_lora=tlora, sft_grad_norm=tnorm)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_tp_embed_dp2_tp4_matches_jax(eight):
    for r in eight["got"]:
        np.testing.assert_allclose(r["embed"], eight["embed"], atol=2e-4)


NEAR_TIE = 1e-2   # a bf16 ulp of logits below 4: the bf16 trunks of the two packages may part there


def test_dp8_greedy_generate_matches_unsharded_and_jax(eight):
    """Every rank's gathered tokens equal the port's unsharded run; that run
    equals JAX's unsharded ``generate_speech`` row by row, or first parts
    from it at a step where the port's two candidates lie within
    ``NEAR_TIE`` (after that the contexts differ)."""
    for r in eight["got"]:
        np.testing.assert_array_equal(r["generate"], eight["generate_unsharded"])
    got, want, logits = eight["generate_unsharded"], eight["generate"], eight["generate_logits"]
    for b in range(got.shape[0]):
        parted = np.flatnonzero(got[b] != want[b])
        if parted.size:
            i = parted[0]
            gap = abs(logits[b, i, got[b, i]] - logits[b, i, want[b, i]])
            assert gap <= NEAR_TIE, f"row {b} parts from JAX at step {i} with a logit gap of {gap}"


def test_cfm_sample_dp4_tp2_matches_unsharded_and_jax(eight):
    for r in eight["got"]:
        np.testing.assert_allclose(r["cfm"], eight["cfm_unsharded"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["cfm"], eight["cfm"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case,atol", [("eight", 2e-4), ("four", 1e-4)])
def test_engine_on_mesh_matches_unsharded(request, case, atol):
    """dp 2 x tp 4 (8 ranks) and dp 4 (4 ranks): every rank returns the
    whole batch, each wav the unsharded engine's."""
    run = request.getfixturevalue(case)
    for r in run["got"]:
        assert r["engine_dp"] == (2 if case == "eight" else 4)
        assert [w.shape for w in r["engine"]] == [w.shape for w in run["engine"]]
        for g, w in zip(r["engine"], run["engine"]):
            np.testing.assert_allclose(g, w, atol=atol)


def test_engine_pads_ragged_batch(four):
    for r in four["got"]:
        assert len(r["ragged"]) == 3
        assert all(w.size > 0 and np.isfinite(w).all() for w in r["ragged"])


def test_sft_step_dp2_tp2_matches_unsharded_and_jax(four):
    """Loss, recorded gradient norm (the clip's, across the ranks) and
    updated LoRA equal the unsharded step's; the loss equals JAX's."""
    for r in four["got"]:
        assert abs(r["sft_loss"] - four["sft_loss"]) <= 1e-5
        assert abs(r["sft_grad_norm"] - four["sft_grad_norm"]) <= 1e-5 * four["sft_grad_norm"]
        assert abs(r["sft_loss"] - four["sft_jax_loss"]) <= 1e-5
        for name, want in four["sft_lora"]["layers"].items():
            np.testing.assert_allclose(r["sft_lora"]["layers"][name], want.numpy(), atol=1e-5, err_msg=name)


def test_engine_collectives_count_on_their_spans(four):
    """dp 4: featurize and the vocoder gather the batch's rows over the
    data group (the rows' widths, then the rows); each collective counts
    on the innermost span open around it, with its host milliseconds."""
    for r in four["got"]:
        counted = {name: (n, ms) for name, n, ms in r["engine_collectives"] if n}
        assert set(counted) == {"featurize", "vocoder"}, counted
        assert all(n == 2 and ms > 0 for n, ms in counted.values()), counted


def test_scanned_decode_keeps_the_eager_step_on_a_model_axis(four):
    """dp 2 x tp 2: the scanned decode's span says its step ran eagerly
    (``graph`` false, no replay, no capture), as it does on a model axis
    anywhere: the step's collectives cannot be captured."""
    for r in four["got"]:
        attrs, counters = r["tp2_decode"]
        assert attrs["path"] == "scanned" and attrs["graph"] is False
        assert counters["steps"] > 0 and counters["graph_replays"] == counters["graph_captures"] == 0


def test_shard_then_gather_is_bitwise(four):
    assert all(r["round_trip"] for r in four["got"])


@pytest.mark.parametrize("target", ["tp1", "tp2", "tp4"])
def test_dcp_checkpoint_saved_at_tp2_restores(four, target):
    assert all(r[f"restore_{target}"] for r in four["got"])


def test_orbax_backend_raises_and_names_dcp(tmp_path):
    with pytest.raises(ValueError, match="dcp"):
        CheckpointManager(tmp_path, backend="orbax")
    (tmp_path / "checkpoint-3" / "state.orbax").mkdir(parents=True)
    with pytest.raises(ValueError, match="dcp"):
        CheckpointManager(tmp_path).restore({}, step=3)


def test_dryrun_engine_four_ranks(capsys):
    out = dryrun_engine(4, device="cpu")
    assert out["mesh"] == {"data": 2, "model": 2} and out["max_abs_err"] <= 2e-4
    assert "dryrun_engine ok" in capsys.readouterr().out


def test_dryrun_train_step_four_ranks(capsys):
    out = tsft.dryrun_train_step(4, device="cpu")
    assert out["mesh"] == {"data": 2, "model": 2} and np.isfinite(out["loss"])
    assert "dryrun_multichip ok" in capsys.readouterr().out
