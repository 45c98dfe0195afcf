"""The port's training gates on behaviour: its own copies of the JAX
package's ``tests/test_retrieval_gate.py::test_sft_improves_retrieval``
and ``tests/test_acoustic_train.py``, at the same sizes and thresholds.

- LoRA SFT on disjoint synonym sets must lift label accuracy and
  precision@5 well above chance and above the base (the paper's core
  claim): p@5 of the base < 1.8x chance; tuned label accuracy > base + 0.25;
  tuned p@5 > 1.8x chance and > base + 0.15. The base and the LoRA start
  from ``PRNGKey(0)`` / ``PRNGKey(1)``, drawn as the JAX package draws them
  (``utils/rng``).
- The token LM, the CFM and the vocoder each overfit one batch: the last
  loss below 0.8x / 0.7x the first, and below the first.
- The VQ losses are positive, zero for a codebook equal to the encodings;
  batch code usage in (0, 1]; gradients reach both encoder and codebook.
- A codebook pushed far off (+50) collapses to <= 2 live codes at first;
  the dead-code restarts bring it to >= 4 within 10 steps.

Each gate is a function of the device, so ``chip_smoke.py`` (path M6) runs
the same gates on the card; here they run on the CPU (``slow``). The SFT
gate runs in f32, as the JAX test does, and in bf16: the flash kernel takes
bf16 activations only, so on the card the gate runs in bf16
(``CARD_GATES``).
"""

import functools

import numpy as np
import pytest
import torch

from autostyle_tts_tpu_torch.models import cfm, frontend, speech_tokenizer, token_lm, vocoder
from autostyle_tts_tpu_torch.models import transformer as core
from autostyle_tts_tpu_torch.ops.stft import log_mel_spectrogram
from autostyle_tts_tpu_torch.pipeline.rag import EmbedderService
from autostyle_tts_tpu_torch.retrieval.store import StyleStore
from autostyle_tts_tpu_torch.train import acoustic, lora_sft
from autostyle_tts_tpu_torch.utils import rng as rng_lib
from autostyle_tts_tpu_torch.utils.config import TrainConfig, TransformerConfig, tiny_config

pytestmark = pytest.mark.slow

# (db-side synonyms, query-side synonyms) per class, deliberately disjoint
SYN = {
    "happy":      (["delighted", "joyful", "thrilled"], ["cheerful", "glad"]),
    "sad":        (["miserable", "gloomy", "sorrowful"], ["downcast", "blue"]),
    "angry":      (["furious", "irate", "enraged"], ["livid", "cross"]),
    "neutral":    (["ordinary", "routine", "plain"], ["regular", "typical"]),
    "excited":    (["ecstatic", "exhilarated", "eager"], ["pumped", "stoked"]),
    "frustrated": (["stuck", "thwarted", "annoyed"], ["exasperated", "irked"]),
}
LABELS = list(SYN)
TEMPL = ["i feel so {w} about this", "that makes me {w} honestly",
         "what a {w} day it has been", "she sounded {w} on the phone",
         "he was {w} when it happened"]


def _sentences(words, n, seed):
    rng = np.random.default_rng(seed)
    return [TEMPL[rng.integers(len(TEMPL))].format(w=words[rng.integers(len(words))]) for _ in range(n)]


def _sample(text, lab=None):
    msgs = [{"role": "system", "content": "label the emotion"}, {"role": "user", "content": text}]
    if lab is not None:
        msgs.append({"role": "assistant", "content": lab})
    return {"messages": msgs}


def sft_retrieval_gate(device: str, dtype: str = "float32") -> dict:
    """-> {p_base, acc_base, p_tuned, acc_tuned, chance, steps}; raises
    AssertionError below the JAX thresholds. ``dtype``: the embedder's
    compute dtype."""
    dev = torch.device(device)
    cfg = TransformerConfig(vocab_size=frontend.VOCAB_SIZE, dim=64, n_layers=2, n_heads=4, n_kv_heads=4,
                            ffn_dim=128, max_seq_len=128, dtype=dtype)
    tcfg = TrainConfig(batch_size=8, grad_accum=1, max_seq_len=64, learning_rate=3e-3, remat=False,
                       neftune_alpha=0.0)
    params = core.init_params(cfg, rng_lib.PRNGKey(0, dev))

    train_samples = []
    for li, lab in enumerate(LABELS):
        for s in _sentences(SYN[lab][0] + SYN[lab][1], 40, li):
            train_samples.append(_sample(s, lab))
    db, dbl, q, ql = [], [], [], []
    for li, lab in enumerate(LABELS):
        for s in _sentences(SYN[lab][0], 8, 100 + li):
            db.append(s)
            dbl.append(lab)
        for s in _sentences(SYN[lab][1], 4, 200 + li):
            q.append(s)
            ql.append(lab)

    opt = lora_sft.make_optimizer(tcfg, 400)
    step = lora_sft.make_train_step(cfg, tcfg, opt, packed=True)
    lora = core.init_lora(cfg, tcfg.lora.r, rng_lib.PRNGKey(1, dev))
    ost = opt.init(lora)
    gen = torch.Generator(device=dev).manual_seed(0)    # NEFTune is off: nothing draws from it
    n = 0
    for epoch in range(12):
        for b in lora_sft.make_packed_batches(train_samples, 64, 8, seed=epoch, pad_to_batch=True):
            lora, ost, _ = step(lora, ost, params, torch.as_tensor(b.tokens, device=dev),
                                torch.as_tensor(b.loss_mask, device=dev), torch.as_tensor(b.segment_ids, device=dev),
                                gen)
            n += 1
    lscale = tcfg.lora.alpha / tcfg.lora.r

    def precision_at_5(lora_, lscale_):
        # label each text through the training-matched chat protocol, then
        # run the production embed + cosine top-k retrieval
        _, preds_db = lora_sft.evaluate_generation(params, cfg, [_sample(t, l) for t, l in zip(db, dbl)], LABELS,
                                                   lora=lora_, lora_scale=lscale_, max_prompt=64, max_new=8)
        _, preds_q = lora_sft.evaluate_generation(params, cfg, [_sample(t, l) for t, l in zip(q, ql)], LABELS,
                                                  lora=lora_, lora_scale=lscale_, max_prompt=64, max_new=8)
        preds_db = [p or "neutral" for p in preds_db]      # the reference's fallback
        preds_q = [p or "neutral" for p in preds_q]
        emb = EmbedderService(cfg, params, lora=lora_, lora_scale=lscale_, labels=LABELS, device=dev)
        store = StyleStore(dim=cfg.dim, capacity=128, device=dev)
        store.insert(emb.embed(preds_db, width=16), [{"file_id": str(i), "text": db[i]} for i in range(len(db))])
        _, idx = store.search_arrays(emb.embed(preds_q, width=16), k=5)
        hits = sum(dbl[j] == ql[i] for i in range(len(q)) for j in idx[i])
        acc = float(np.mean([p == t for p, t in zip(preds_q, ql)]))
        return hits / (len(q) * 5), acc

    p_base, acc_base = precision_at_5(None, 0.0)
    p_tuned, acc_tuned = precision_at_5(lora, lscale)
    chance = 1.0 / len(LABELS)
    out = {"p_base": p_base, "acc_base": acc_base, "p_tuned": p_tuned, "acc_tuned": acc_tuned,
           "chance": chance, "steps": n}
    assert p_base < chance * 1.8, out
    assert acc_tuned > acc_base + 0.25, out
    assert p_tuned > chance * 1.8, out
    assert p_tuned > p_base + 0.15, out
    return out


def _run_steps(step, params, opt_state, batch, dev, n=12):
    losses = []
    for i in range(n):
        params, opt_state, loss = step(params, opt_state, batch, torch.Generator(device=dev).manual_seed(i))
        losses.append(float(loss))
    return losses


def token_lm_overfit_gate(device: str) -> list:
    dev = torch.device(device)
    tl = tiny_config().token_lm
    params = token_lm.init_params(tl, torch.Generator(device=dev).manual_seed(0))
    opt = acoustic.default_optimizer(lr=3e-3)
    step = acoustic.make_token_lm_step(tl, opt, remat=False)
    r = np.random.default_rng(0)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    batch = {"text": t(r.integers(16, 200, (2, 6))), "text_len": t([6, 4]),
             "style_tokens": t(r.integers(0, 64, (2, 4))), "style_len": t([4, 3]),
             "spk": t(r.standard_normal((2, tl.spk_dim)), torch.float32),
             "targets": t(r.integers(0, 64, (2, 8))), "target_len": t([8, 6])}
    losses = _run_steps(step, params, opt.init(params), batch, dev)
    assert losses[-1] < losses[0] * 0.8, losses
    return losses


def cfm_overfit_gate(device: str) -> list:
    dev = torch.device(device)
    c = tiny_config().cfm
    params = cfm.init_params(c, torch.Generator(device=dev).manual_seed(0))
    opt = acoustic.default_optimizer(lr=3e-3)
    opt_state = opt.init(params)
    step = acoustic.make_cfm_step(c, opt, cond_drop_prob=0.0)
    r = np.random.default_rng(0)
    B, T_tok = 2, 6
    F = T_tok * c.upsample
    prompt_mask = torch.zeros((B, F), device=dev)
    prompt_mask[:, :2] = 1.0
    batch = {"tokens": torch.as_tensor(r.integers(0, 64, (B, T_tok)), dtype=torch.int32, device=dev),
             "mel": torch.as_tensor(r.standard_normal((B, F, c.n_mels)), dtype=torch.float32, device=dev),
             "spk": torch.as_tensor(r.standard_normal((B, c.spk_dim)), dtype=torch.float32, device=dev),
             "prompt_mask": prompt_mask, "frame_mask": torch.ones((B, F), device=dev)}
    # a fixed seed each step -> a fixed (x0, t) draw; the step must fit that target
    losses = []
    for _ in range(25):
        params, opt_state, loss = step(params, opt_state, batch, torch.Generator(device=dev).manual_seed(7))
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses
    return losses


def vocoder_overfit_gate(device: str) -> list:
    dev = torch.device(device)
    cfg = tiny_config()
    v, a = cfg.vocoder, cfg.audio
    params = vocoder.init_params(v, torch.Generator(device=dev).manual_seed(0))
    opt = acoustic.default_optimizer(lr=1e-3)
    step = acoustic.make_vocoder_step(v, opt, sr=a.sample_rate, n_fft=a.n_fft, hop=a.hop_length)
    F = 16
    t = np.arange(F * vocoder.total_upsample(v)) / a.sample_rate
    wav = torch.as_tensor((0.5 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)[None, :], device=dev)
    mel = log_mel_spectrogram(wav, a.sample_rate, a.n_fft, a.hop_length, n_mels=v.n_mels)[:, :F]
    losses = _run_steps(step, params, opt.init(params), {"mel": mel, "wav": wav}, dev, n=15)
    assert losses[-1] < losses[0], losses
    return losses


def vq_gate(device: str) -> dict:
    """The VQ losses and usage, and their gradients."""
    dev = torch.device(device)
    st = tiny_config().speech_tokenizer
    r = np.random.default_rng(0)
    codebook = torch.as_tensor(r.standard_normal((st.codebook_size, st.dim)), dtype=torch.float32, device=dev)
    pre = torch.as_tensor(r.standard_normal((2, 10, st.dim)), dtype=torch.float32, device=dev)
    cb_loss, commit = acoustic.vq_losses(codebook, pre, torch.ones((2, 10), device=dev))
    assert float(cb_loss) > 0 and float(commit) > 0
    pre1 = codebook[torch.tensor([[1, 2, 3]], device=dev)]       # a codebook equal to the encodings
    cb0, cm0 = acoustic.vq_losses(codebook, pre1, torch.ones((1, 3), device=dev))
    assert float(cb0) < 1e-10 and float(cm0) < 1e-10
    usage = float(acoustic.codebook_usage(speech_tokenizer.quantize(codebook, pre), st.codebook_size))
    assert 0.0 < usage <= 1.0

    r1 = np.random.default_rng(1)
    cb = torch.as_tensor(r1.standard_normal((st.codebook_size, st.dim)), dtype=torch.float32, device=dev)
    h = torch.as_tensor(r1.standard_normal((1, 5, st.dim)), dtype=torch.float32, device=dev)
    mask = torch.ones((1, 5), device=dev)
    g_cb = torch.autograd.grad(acoustic.vq_losses(cb.requires_grad_(), h, mask)[0], cb)[0]
    g_enc = torch.autograd.grad(acoustic.vq_losses(cb.detach(), h.requires_grad_(), mask)[1], h)[0]
    assert float(g_cb.abs().max()) > 0 and float(g_enc.abs().max()) > 0
    return {"cb_loss": float(cb_loss), "commit": float(commit), "usage": usage}


def dead_code_gate(device: str) -> list:
    """A codebook pushed far from the features (+50) collapses to one
    nearest code; the usage-EMA restarts re-seed dead codes onto the
    features, so batch code usage recovers."""
    dev = torch.device(device)
    cfg = tiny_config()
    st, a = cfg.speech_tokenizer, cfg.audio
    opt = acoustic.default_optimizer(lr=1e-3)
    step = acoustic.make_tokenizer_step(st, a, opt, 8, usage_decay=0.5)
    params = {"tok": speech_tokenizer.init_params(st, torch.Generator(device=dev).manual_seed(0)),
              "head": acoustic.init_tokenizer_head(torch.Generator(device=dev).manual_seed(1), st, 8)}
    params["tok"]["codebook"] = params["tok"]["codebook"] + 50.0
    opt_state = opt.init(params)
    usage = acoustic.init_usage(st, device=dev)
    r = np.random.default_rng(0)
    T = a.prompt_sample_rate
    batch = {"wav16": torch.as_tensor(0.3 * np.sin(2 * np.pi * 220 * np.arange(2 * T).reshape(2, T)
                                                   / a.prompt_sample_rate)
                                      + 0.05 * r.standard_normal((2, T)), dtype=torch.float32, device=dev),
             "len": torch.tensor([T, T // 2], dtype=torch.int32, device=dev),
             "phn": torch.as_tensor(r.integers(0, 8, (2, 64)), dtype=torch.int32, device=dev)}
    used = []
    for i in range(10):
        params, opt_state, usage, loss, ce, acc, n_used = step(params, opt_state, usage, batch,
                                                                 torch.Generator(device=dev).manual_seed(i))
        used.append(int(n_used))
    assert used[0] <= 2, used
    assert used[-1] >= 4, used
    assert float(params["tok"]["codebook"].abs().max()) < 60.0
    return used


GATES = {"sft_retrieval": sft_retrieval_gate,
         "sft_retrieval_bf16": functools.partial(sft_retrieval_gate, dtype="bfloat16"),
         "token_lm_overfit": token_lm_overfit_gate, "cfm_overfit": cfm_overfit_gate,
         "vocoder_overfit": vocoder_overfit_gate, "vq": vq_gate, "dead_code_restarts": dead_code_gate}
CARD_GATES = [name for name in GATES if name != "sft_retrieval"]


@pytest.mark.parametrize("name", list(GATES))
def test_training_gate_cpu(name):
    GATES[name]("cpu")
