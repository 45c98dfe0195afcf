"""Port parity for the LoRA SFT slice (``train/lora_sft.py``,
``train/reformat.py``) and its files, against the JAX package.

- bitwise: ``reformat`` rows and files on ``tests/test_train.py``'s
  inputs, ``render_chat`` / ``decode_assistant``, ``ffd_pack``, the
  packed and unpacked batches;
- ``sft_loss`` / ``packed_sft_loss`` and their LoRA gradients at f32
  (NEFTune 0, and NEFTune 5 with the JAX draw handed to the port): loss rel
  1e-5, gradients max |delta| <= 1e-4 * max |g|; remat gives the gradients
  of no remat (rel 1e-6: the same ops, recomputed); the base gets none;
- one MultiSteps train step against optax's: the LoRA after the update to
  1e-6 where the gradient is resolved (as in ``test_torch_train_acoustic``);
- ``evaluate_generation``'s greedy texts equal the JAX package's;
- the ``train()`` contract and its files read by either package.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autostyle_tts_tpu.models import transformer as jcore
from autostyle_tts_tpu.train import lora_sft as jsft
from autostyle_tts_tpu.train import reformat as jref
from autostyle_tts_tpu.utils import checkpoint as jckpt
from autostyle_tts_tpu.utils import tb_events as jtb
from autostyle_tts_tpu.utils.config import TrainConfig, TransformerConfig
from autostyle_tts_tpu_torch.models import frontend
from autostyle_tts_tpu_torch.models import transformer as tcore
from autostyle_tts_tpu_torch.train import lora_sft as tsft
from autostyle_tts_tpu_torch.train import optim
from autostyle_tts_tpu_torch.train import reformat as tref
from autostyle_tts_tpu_torch.utils import checkpoint as tckpt
from autostyle_tts_tpu_torch.utils import rng
from autostyle_tts_tpu_torch.utils import tb_events as ttb
from autostyle_tts_tpu_torch.weights import _flat_keys, tree_from_numpy

from torch_one_thread import one_thread  # noqa: F401


def _cfg():
    return TransformerConfig(vocab_size=frontend.VOCAB_SIZE, dim=48, n_layers=2, n_heads=4, n_kv_heads=2,
                             ffn_dim=96, max_seq_len=128, dtype="float32")


def _samples(n=8):
    return [{"messages": [{"role": "system", "content": "classify"},
                          {"role": "user", "content": f"utterance {i}"},
                          {"role": "assistant", "content": "happy" if i % 2 else "sad"}]} for i in range(n)]


def _fake_conv():
    return {"labels": [0, 2, 5], "sentences": ["I love this!", "Okay.", "This is hopeless."],
            "genders": ["F", "M", "F"]}


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _flat(tree):
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in _flat_keys(tree).items()}


def _weights(cfg, seed=0):
    """A JAX base and a LoRA whose b is nonzero (every pair on the path)."""
    params = _np(jcore.init_params(jax.random.PRNGKey(seed), cfg))
    lora = _np(jcore.init_lora(jax.random.PRNGKey(seed + 1), cfg, 4))
    rng = np.random.default_rng(seed)
    for k in lora["layers"]:
        if k.endswith("_lora_b"):
            lora["layers"][k] = (rng.standard_normal(lora["layers"][k].shape) * 0.02).astype(np.float32)
    return params, lora


# ----------------------------------------------------------------------------- bitwise


def test_reformat_rows_and_files_equal_jax(tmp_path):
    conv = _fake_conv()
    cases = [dict(s_id="Ses01_x", conv=conv, window=1), dict(s_id="Ses02_y", conv=dict(conv, labels=[0, 1, 6]),
                                                              window=5, language="zh"),
             dict(s_id="Ses02_y", conv=dict(conv, labels=[0, 1, 6], speakers=["甲", "乙", "甲"]), language="zh"),
             dict(s_id="Ses01_x", conv=conv, window=0),
             dict(s_id="Ses01_x", conv=conv, mode="spdescV2", bios=["<s>a bio\nwith lines</s>junk", "b", "c"])]
    for kw in cases:
        assert tref.conversation_to_messages(**kw) == jref.conversation_to_messages(**kw)
    src = tmp_path / "iemocap.valid.json"
    src.write_text(json.dumps({"Ses01_a": conv, "Ses03_b": dict(conv, labels=[1, 3, 4])}))
    for mod, name in ((jref, "j.jsonl"), (tref, "t.jsonl")):
        assert mod.process_dataset(str(src), str(tmp_path / name), window=2) == 6
    assert (tmp_path / "j.jsonl").read_bytes() == (tmp_path / "t.jsonl").read_bytes()
    assert tref.default_output_path(str(src), 5, "default") == jref.default_output_path(str(src), 5, "default")
    assert tref.label_set("zh") == jref.label_set("zh")


def test_chat_template_equal_jax():
    msgs = [{"role": "system", "content": "sys ### ü"}, {"role": "user", "content": "q 你好"},
            {"role": "assistant", "content": "happy"}]
    for gen_prompt in (False, True):
        for a, b in zip(tsft.render_chat(msgs, gen_prompt), jsft.render_chat(msgs, gen_prompt)):
            np.testing.assert_array_equal(a, b)
    B = frontend.BYTE_OFFSET
    for ids in ([B + 104, B + 105, 13], [90000, B + 111, B + 107, 120000], [99999, 123456], [0, 13, B + 97]):
        assert tsft.decode_assistant(ids) == jsft.decode_assistant(ids)


def test_packing_and_batches_equal_jax():
    for lens, cap in (([64] * 8 + [30] * 8, 96), ([5, 90, 33, 33, 60, 1, 95, 40], 100)):
        assert tsft.ffd_pack(lens, cap) == jsft.ffd_pack(lens, cap)
    samples = _samples(9)
    for kw in (dict(shuffle=False), dict(seed=3), dict(seed=1, pad_to_batch=True)):
        tb = list(tsft.make_packed_batches(samples, 96, 2, **kw))
        jb = list(jsft.make_packed_batches(samples, 96, 2, **kw))
        assert len(tb) == len(jb)
        for x, y in zip(tb, jb):
            for f in ("tokens", "loss_mask", "segment_ids"):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    for kw in (dict(shuffle=False), dict(seed=5, drop_last=True)):
        for x, y in zip(tsft.make_batches(samples, 40, 4, **kw), jsft.make_batches(samples, 40, 4, **kw)):
            for f in ("tokens", "loss_mask", "length"):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f))
    rendered = tsft.render_samples(samples, 30)
    assert tsft.packed_row_count(rendered, 96) == jsft.packed_row_count(jsft.render_samples(samples, 30), 96)


# ----------------------------------------------------------------------------- losses


def _loss_inputs(packed: bool):
    samples = _samples(6)
    if packed:
        b = next(jsft.make_packed_batches(samples, 96, 2, shuffle=False))
        return b.tokens, b.loss_mask, b.segment_ids
    b = next(jsft.make_batches(samples, 40, 3, shuffle=False))
    return b.tokens, b.loss_mask, b.length


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("neftune", [0.0, 5.0])
def test_sft_loss_and_lora_grads_match(packed, neftune):
    cfg = _cfg()
    params, lora = _weights(cfg)
    toks, mask, aux = _loss_inputs(packed)
    key = jax.random.PRNGKey(3)
    jfn, tfn = (jsft.packed_sft_loss, tsft.packed_sft_loss) if packed else (jsft.sft_loss, tsft.sft_loss)
    kw = dict(lora_scale=4.0, neftune_alpha=neftune, remat=False)
    vg = jax.jit(jax.value_and_grad(lambda lo, p, t, m, a, k: jfn(lo, p, cfg, t, m, a, k, **kw)))
    jl, jg = vg(jax.tree_util.tree_map(jnp.asarray, lora), jax.tree_util.tree_map(jnp.asarray, params),
                jnp.asarray(toks), jnp.asarray(mask), jnp.asarray(aux), key)
    # the JAX draw: uniform in [-1, 1) over the embeddings' shape, from the same key
    noise = torch.from_numpy(np.array(jax.random.uniform(key, toks.shape + (cfg.dim,), jnp.float32, -1.0, 1.0)))
    tp = tree_from_numpy(params)
    grads = {}
    for remat in (False, True):
        tl = tree_from_numpy(lora)
        for t in optim.tree_leaves(tl):
            t.requires_grad_(True)
        loss = tfn(tl, tp, cfg, torch.from_numpy(toks), torch.from_numpy(mask), torch.from_numpy(aux), None,
                   lora_scale=4.0, neftune_alpha=neftune, remat=remat, noise=noise if neftune else None)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
        grads[remat] = {k: v.grad.numpy() for k, v in _flat_keys(tl).items()}
    assert all(t.grad is None and not t.requires_grad for t in optim.tree_leaves(tp))    # the base: no grad
    for k, want in _flat(_np(jg)).items():
        assert float(np.abs(grads[False][k] - want).max()) <= 1e-4 * float(np.abs(want).max()), k
        np.testing.assert_allclose(grads[True][k], grads[False][k], rtol=1e-6, atol=1e-9 * np.abs(want).max())


def test_packed_loss_matches_unpacked():
    """Two samples packed in one row score as the two rows apart."""
    cfg = _cfg()
    params, lora = _weights(cfg, seed=2)
    tp, tl = tree_from_numpy(params), tree_from_numpy(lora)
    samples = _samples(2)
    num = den = 0.0
    for s in samples:
        ids, lm = tsft.render_chat(s["messages"])
        loss = tsft.sft_loss(tl, tp, cfg, torch.from_numpy(ids[None]), torch.from_numpy(lm[None]),
                             torch.tensor([len(ids)]), None, lora_scale=2.0, remat=False)
        n = int((lm[1:] > 0).sum())
        num, den = num + float(loss) * n, den + n
    b = next(tsft.make_packed_batches(samples, 96, 1, shuffle=False))
    assert b.segment_ids.max() == 2
    got = tsft.packed_sft_loss(tl, tp, cfg, torch.from_numpy(b.tokens), torch.from_numpy(b.loss_mask),
                               torch.from_numpy(b.segment_ids), None, lora_scale=2.0, remat=False)
    np.testing.assert_allclose(float(got), num / den, rtol=2e-5)


def test_multisteps_train_step_matches_optax():
    """Two micro-steps through MultiSteps(k=2) on each side: no update after
    the first, the mean of the two gradients applied on the second."""
    cfg = _cfg()
    tcfg = TrainConfig(batch_size=2, grad_accum=2, max_seq_len=40, neftune_alpha=0.0, remat=True, packing=False,
                       learning_rate=1e-3)
    params, lora = _weights(cfg, seed=4)
    jopt = optax.MultiSteps(jsft.make_optimizer(tcfg, 5), every_k_schedule=2)
    topt = optim.MultiSteps(tsft.make_optimizer(tcfg, 5), 2)
    jstep = jsft.make_train_step(cfg, tcfg, jopt)
    tstep = tsft.make_train_step(cfg, tcfg, topt)
    jl, js = jax.tree_util.tree_map(jnp.array, lora), None
    js = jopt.init(jl)
    tl, ts = tree_from_numpy(lora), None
    ts = topt.init(tl)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tree_from_numpy(params)
    for i, b in enumerate(jsft.make_batches(_samples(4), 40, 2, shuffle=False)):
        jl, js, jloss = jstep(jl, js, jp, jnp.asarray(b.tokens), jnp.asarray(b.loss_mask), jnp.asarray(b.length),
                              jax.random.PRNGKey(i))
        tl, ts, tloss = tstep(tl, ts, tp, torch.from_numpy(b.tokens), torch.from_numpy(b.loss_mask),
                              torch.from_numpy(b.length), None)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    mean_g = _flat(_np(js.acc_grads))   # reset to 0 on the applied step; compare the moments instead
    jmu = _flat(_np(js.inner_opt_state[1][0].mu))
    tmu = _flat(ts["inner"][1]["mu"])
    for k in jmu:
        assert float(np.abs(jmu[k] - tmu[k]).max()) <= 1e-4 * float(np.abs(jmu[k]).max()) + 1e-30, k
        assert not mean_g[k].any()
    jlf, tlf, l0 = _flat(_np(jl)), _flat(tl), _flat(lora)
    for k in jlf:
        resolved = np.abs(jmu[k]) > 1e-4 * np.abs(jmu[k]).max()
        d = np.abs(jlf[k] - tlf[k])
        assert float(np.where(resolved, d, 0).max(initial=0)) <= 1e-6, k
        assert np.any(jlf[k] != l0[k]), k
    assert int(ts["gradient_step"]) == int(js.gradient_step) == 1


def test_evaluate_generation_greedy_texts_equal_jax(monkeypatch):
    cfg = _cfg()
    params, lora = _weights(cfg, seed=6)
    samples = _samples(5)
    # compare the decoded generations themselves, not only the labels they map to
    monkeypatch.setattr(jsft, "match_label", lambda text, labels: text)
    monkeypatch.setattr(tsft, "match_label", lambda text, labels: text)
    labels = ["happy", "sad"]
    jf1, jpred = jsft.evaluate_generation(jax.tree_util.tree_map(jnp.asarray, params), cfg, samples, labels,
                                          lora=jax.tree_util.tree_map(jnp.asarray, lora), lora_scale=4.0,
                                          batch_size=4, max_prompt=48, max_new=6)
    tf1, tpred = tsft.evaluate_generation(tree_from_numpy(params), cfg, samples, labels,
                                          lora=tree_from_numpy(lora), lora_scale=4.0, batch_size=4, max_prompt=48,
                                          max_new=6)
    assert tpred == jpred and tf1 == jf1 and len(tpred) == 5


def test_weighted_f1_and_match_label_equal_jax():
    labels = jref.label_set("en")
    y = ["happy", "sad", "sad", "neutral", "angry"]
    for p in (y, ["happy", "sad", "happy", "", "angry"], ["sad"] * 5):
        assert tsft.weighted_f1(y, p, labels) == jsft.weighted_f1(y, p, labels)
    for text in ("happy", "  Frustrated!", "the label is sad", "nonsense", "excitedly neutral"):
        assert tsft.match_label(text, labels) == jsft.match_label(text, labels)


# ----------------------------------------------------------------------------- train() and its files


def test_train_contract_resume_and_files(tmp_path):
    cfg = _cfg()
    tcfg = TrainConfig(batch_size=2, grad_accum=2, epochs=1, max_seq_len=96, eval_every=1, save_every=1,
                       remat=True, seed=3)
    params = tree_from_numpy(_np(jcore.init_params(jax.random.PRNGKey(0), cfg)))
    out = tmp_path / "ft"
    logs = []
    res = tsft.train(params, cfg, tcfg, _samples(16), eval_samples=_samples(3), labels=["happy", "sad"],
                     out_dir=str(out), log_every=1, log=logs.append)
    assert res["packing"] and res["steps"] >= 1
    assert len(list(out.glob("checkpoint-*"))) == 1     # save_total_limit 1
    hist = json.loads((out / "history.json").read_text())
    assert [h["step"] for h in hist if "loss" in h] == list(range(1, res["steps"] + 1))
    assert any("eval_weighted_f1" in h for h in hist)
    assert (out / "best.npz").exists() and res["best_f1"] >= 0
    # the events file reads in both packages
    ev = next((out / "tb").glob("events.out.tfevents.*"))
    assert ttb.read_scalars(ev) == jtb.read_scalars(ev)
    assert [s for s, tag, _ in jtb.read_scalars(ev) if tag == "train/loss"] == list(range(1, res["steps"] + 1))
    # best.npz loads as a LoRA tree in the JAX package, and back in the port
    jlora = jckpt.load_pytree(out / "best.npz", jcore.init_lora(jax.random.PRNGKey(0), cfg, tcfg.lora.r))
    like = tcore.init_lora(cfg, tcfg.lora.r, rng.PRNGKey(0))
    tlora = tckpt.load_pytree(out / "best.npz", like)
    for k, v in _flat(tlora).items():
        np.testing.assert_array_equal(v, _flat(_np(jlora))[k])
    # resume: the latest checkpoint is at the end of the schedule, so a second call trains nothing
    res2 = tsft.train(params, cfg, tcfg, _samples(16), out_dir=str(out), log=logs.append)
    assert res2["steps"] == res["steps"]
    for k, v in _flat(res2["lora"]).items():
        np.testing.assert_array_equal(v, _flat(res["lora"])[k])


def test_train_packing_auto_disables_and_resumes_optimizer_state(tmp_path):
    cfg = _cfg()
    tcfg = TrainConfig(batch_size=2, grad_accum=1, epochs=2, max_seq_len=48, eval_every=1000, save_every=1,
                       remat=False)
    params = tree_from_numpy(_np(jcore.init_params(jax.random.PRNGKey(0), cfg)))
    logs = []

    def stop_at_4(msg):
        logs.append(msg)
        if "step 4/" in msg:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):     # cut after step 3's checkpoint, during step 4
        tsft.train(params, cfg, tcfg, _samples(6), out_dir=str(tmp_path), log_every=1, log=stop_at_4)
    assert any("packing auto-disabled" in m for m in logs)    # ~31-token samples, one a 48-token row
    assert tckpt.CheckpointManager(tmp_path).latest_step() == 3
    res = tsft.train(params, cfg, tcfg, _samples(6), out_dir=str(tmp_path), log_every=1, log=logs.append)
    assert not res["packing"] and res["steps"] == 6
    like = {"lora": res["lora"], "opt_state": optim.MultiSteps(tsft.make_optimizer(tcfg, 6), 1).init(res["lora"])}
    state = tckpt.CheckpointManager(tmp_path).restore(like)
    # the optimizer's counts went on from the checkpoint (3 + 3 applied steps), not from 0
    assert int(state["opt_state"]["gradient_step"]) == 6
    assert int(state["opt_state"]["inner"][1]["count"]) == 6
    assert int(state["opt_state"]["inner"][1]["sched_count"]) == 6


def test_checkpoint_files_cross_packages(tmp_path):
    """save_pytree / CheckpointManager files of either package restore in
    the other (parameter trees; optimizer state stays in its package)."""
    cfg = _cfg()
    params, lora = _weights(cfg, seed=8)
    jckpt.CheckpointManager(tmp_path / "j").save(7, {"lora": lora})
    got = tckpt.CheckpointManager(tmp_path / "j").restore({"lora": tree_from_numpy(lora)})
    for k, v in _flat(got).items():
        np.testing.assert_array_equal(v, _flat({"lora": lora})[k])
    tm = tckpt.CheckpointManager(tmp_path / "t", save_total_limit=2)
    for step in (1, 2, 3):
        tm.save(step, tree_from_numpy(params), metadata={"note": step})
    assert sorted(p.name for p in (tmp_path / "t").glob("checkpoint-*")) == ["checkpoint-2", "checkpoint-3"]
    jgot = jckpt.CheckpointManager(tmp_path / "t").restore(jax.tree_util.tree_map(jnp.asarray, params))
    for k, v in _flat(_np(jgot)).items():
        np.testing.assert_array_equal(v, _flat(params)[k])
    meta = json.loads((tmp_path / "t" / "checkpoint-3" / "state.npz.meta.json").read_text())
    assert meta["step"] == 3 and meta["note"] == 3 and meta["keys"] == sorted(_flat(params))
    with pytest.raises(ValueError, match="orbax"):
        tckpt.CheckpointManager(tmp_path / "o", backend="orbax")
    with pytest.raises(ValueError, match="missing keys"):
        tckpt.load_pytree(tmp_path / "t" / "checkpoint-3" / "state.npz", {"missing": torch.zeros(2)})
