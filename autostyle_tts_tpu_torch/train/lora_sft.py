"""LoRA SFT of the style-embedder LLM on ERC chat data.

Counterpart of the JAX ``train/lora_sft.py``, the reference's QLoRA recipe
(r=32, alpha=128, all-linear; bs 4 x grad-accum 4; lr 3e-4 linear; 3
epochs; NEFTune alpha 5; gradient checkpointing; eval and save every 50
steps; the best adapter by generation-based weighted F1):

- the chat template and ``decode_assistant`` (``pipeline/erc_chat.py``,
  the port's copy of the format the embedder serves);
- batches: right-padded rows (``make_batches``) or whole samples packed
  into rows by first-fit-decreasing (``ffd_pack``, ``make_packed_batches``)
  with a block-diagonal mask and per-segment positions;
- loss: next-token cross-entropy on the assistant spans (``sft_loss`` /
  ``packed_sft_loss``), NEFTune noise on the input embeddings drawn from a
  ``torch.Generator`` or given as ``noise`` (uniform in [-1, 1], scaled by
  alpha / sqrt(T * D) here);
- only the LoRA tree gets gradients: the base (dense or int8 ``QTensor``)
  never requires grad, so autograd allocates nothing for it;
- ``remat``: each layer under ``torch.utils.checkpoint``;
- eval: greedy 10-token generation under ``torch.no_grad`` (the prefill
  through the flash kernel on the card) -> weighted F1;
- ``train``: packing turned off where it would cut fewer than 1.1x rows,
  ``MultiSteps`` accumulation, eval / save every N applied steps,
  ``best.npz``, resume from the latest checkpoint, ``history.json`` and
  TensorBoard events.

Under a mesh (``make_train_step(..., mesh=)``, ``parallel/``) the step
takes the global batch and computes its data rank's rows on its model
group's slices: the base, the LoRA tree and the optimizer state sharded
alike (``parallel.shard_params``). The loss is the global batch's: each data
rank divides its rows' summed loss by the weight of the whole batch, so
the data group's gradients sum (one all-reduce a leaf) to the unsharded
step's. A LoRA ``A`` of a column-parallel base is replicated inside the
tensor-parallel region and passes ``copy_to_model``, which sums its partial
gradients over the model group; a ``B`` of a row-parallel base reads the
reduced ``x @ A`` and gets its whole gradient on every rank. The clip's
global norm counts the cut leaves' squares summed over the model group and
the whole leaves' once (``mesh_norm``): the step applies its optimizer
inside ``optim.sharded_norm``, so the clip of any optimizer it is given
reads that norm. NEFTune draws the whole batch's
noise and keeps its rows. ``dryrun_train_step`` runs one such step over
spawned ranks against the unsharded step.
"""

from __future__ import annotations

import json
from contextlib import nullcontext
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..models import frontend
from ..models import transformer as core
from ..ops.attention import causal_mask
from ..ops.sampling import SamplerConfig
from ..parallel import comm
from ..parallel.sharding import batch_sharding
from ..pipeline.erc_chat import ASSIST, END, SYS, USER, decode_assistant, render_chat  # noqa: F401
from ..utils import rng
from ..utils.checkpoint import CheckpointManager, save_pytree
from ..utils.config import TrainConfig, TransformerConfig
from ..weights import tree_map
from .optim import (GradientTransformation, MultiSteps, adamw, apply_optimizer, chain, clip_by_global_norm,
                    linear_schedule, sharded_norm, tree_leaves, value_and_grad)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class Batch:
    tokens: np.ndarray      # [B, T]
    loss_mask: np.ndarray   # [B, T]
    length: np.ndarray      # [B]


@dataclass
class PackedBatch:
    tokens: np.ndarray       # [B, T]
    loss_mask: np.ndarray    # [B, T]
    segment_ids: np.ndarray  # [B, T], 0 = pad; equal ids attend each other


def render_samples(samples: List[dict], max_seq_len: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Every chat sample rendered once, tail-truncated to max_seq_len (the
    assistant span is at the end)."""
    out = []
    for s in samples:
        ids, lm = render_chat(s["messages"])
        if len(ids) > max_seq_len:
            ids, lm = ids[-max_seq_len:], lm[-max_seq_len:]
        out.append((ids, lm))
    return out


def ffd_pack(lengths: List[int], max_seq_len: int) -> List[List[int]]:
    """First-fit-decreasing bin packing: sample indices -> rows whose
    lengths sum to at most max_seq_len."""
    order = sorted(range(len(lengths)), key=lambda i: -lengths[i])
    rows: List[List[int]] = []
    space: List[int] = []
    for i in order:
        li = lengths[i]
        for r, sp in enumerate(space):
            if li <= sp:
                rows[r].append(i)
                space[r] = sp - li
                break
        else:
            rows.append([i])
            space.append(max_seq_len - li)
    return rows


def packed_row_count(rendered: List[Tuple[np.ndarray, np.ndarray]], max_seq_len: int) -> int:
    """Rows the FFD packer emits for these samples."""
    return len(ffd_pack([len(ids) for ids, _ in rendered], max_seq_len))


def make_packed_batches(samples: List[dict], max_seq_len: int, batch_size: int, seed: int = 0,
                        shuffle: bool = True, pad_to_batch: bool = False,
                        rendered: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None) -> Iterator[PackedBatch]:
    """Whole samples packed into rows of max_seq_len (FFD), a segment id a
    token; ``shuffle`` permutes the rows; ``pad_to_batch`` emits every batch
    at [batch_size, max_seq_len] with all-pad trailing rows."""
    if rendered is None:
        rendered = render_samples(samples, max_seq_len)
    idx_rows = ffd_pack([len(ids) for ids, _ in rendered], max_seq_len)
    rows = [[rendered[i] for i in row] for row in idx_rows]
    if shuffle:
        rng = np.random.default_rng(seed)
        rows = [rows[r] for r in rng.permutation(len(rows))]
    for s in range(0, len(rows), batch_size):
        chunk = rows[s : s + batch_size]
        B = batch_size if pad_to_batch else len(chunk)
        toks = np.zeros((B, max_seq_len), np.int32)
        mask = np.zeros((B, max_seq_len), np.int32)
        seg = np.zeros((B, max_seq_len), np.int32)
        for b, row in enumerate(chunk):
            off = 0
            for si, (ids, lm) in enumerate(row, start=1):
                toks[b, off : off + len(ids)] = ids
                mask[b, off : off + len(ids)] = lm
                seg[b, off : off + len(ids)] = si
                off += len(ids)
        yield PackedBatch(toks, mask, seg)


def make_batches(samples: List[dict], max_seq_len: int, batch_size: int, seed: int = 0, shuffle: bool = True,
                 drop_last: bool = False,
                 rendered: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None) -> Iterator[Batch]:
    """Right-padded [B, max_seq_len] batches."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(samples)) if shuffle else np.arange(len(samples))
    if rendered is None:
        rendered = render_samples(samples, max_seq_len)
    for s in range(0, len(order), batch_size):
        idx = order[s : s + batch_size]
        if drop_last and len(idx) < batch_size:
            break
        toks = np.zeros((len(idx), max_seq_len), np.int32)
        mask = np.zeros((len(idx), max_seq_len), np.int32)
        lens = np.zeros((len(idx),), np.int32)
        for j, i in enumerate(idx):
            ids, lm = rendered[i]
            toks[j, : len(ids)] = ids
            mask[j, : len(ids)] = lm
            lens[j] = len(ids)
        yield Batch(toks, mask, lens)


# ----------------------------------------------------------------------- loss / step


def neftune_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """NEFTune's uniform draw in [-1, 1), before its alpha / sqrt(T * D) scale."""
    return torch.rand(shape, generator=generator, device=device, dtype=torch.float32) * 2.0 - 1.0


def _embed(params: Dict, cfg: TransformerConfig, tokens: torch.Tensor, generator, neftune_alpha: float,
           noise: Optional[torch.Tensor]) -> torch.Tensor:
    if int(tokens.max()) >= cfg.vocab_size:    # the reference's gather clamps, its loss reads NaN there
        raise ValueError(f"token id {int(tokens.max())} >= vocab_size {cfg.vocab_size}")
    embeds = core.embed(params["tok_emb"], tokens, cfg.vocab_size).to(_DTYPES[cfg.dtype])
    if neftune_alpha > 0:
        T = tokens.shape[1]
        scale = neftune_alpha / float(np.sqrt(np.float32(T * cfg.dim)))
        u = noise if noise is not None else neftune_noise(generator, embeds.shape, embeds.device)
        embeds = embeds + (u.to(embeds.device, torch.float32) * scale).to(embeds.dtype)
    return embeds


def loss_weights(loss_mask: torch.Tensor, segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T-1] weight of each next-token target: on the assistant spans,
    and in a packed row only where the target continues its segment."""
    w = loss_mask[:, 1:] > 0
    if segment_ids is not None:
        seg = segment_ids.long()
        w = w & (seg[:, 1:] == seg[:, :-1])
    return w.float()


def _next_token_nll(hidden: torch.Tensor, params: Dict, cfg: TransformerConfig, tokens: torch.Tensor,
                    w: torch.Tensor, weight_total: Optional[torch.Tensor]) -> torch.Tensor:
    logits = core.head_logits(hidden[:, :-1], core._head(params), cfg.vocab_size).float()
    nll = -torch.gather(torch.log_softmax(logits, dim=-1), -1, tokens[:, 1:].long()[..., None])[..., 0]
    total = torch.clamp(w.sum(), min=1.0) if weight_total is None else weight_total
    return (nll * w).sum() / total


def sft_loss(lora: Dict, params: Dict, cfg: TransformerConfig, tokens: torch.Tensor, loss_mask: torch.Tensor,
             length: torch.Tensor, generator: Optional[torch.Generator], *, lora_scale: float,
             neftune_alpha: float = 0.0, remat: bool = True, noise: Optional[torch.Tensor] = None,
             weight_total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked next-token cross-entropy of right-padded rows, divided by the
    rows' target weight or by ``weight_total`` (a data rank's share of a
    global batch's loss)."""
    B, T = tokens.shape
    dev = tokens.device
    attn = causal_mask(T, T, device=dev) & (torch.arange(T, device=dev)[None, None, None, :]
                                             < length.to(dev).long()[:, None, None, None])
    embeds = _embed(params, cfg, tokens, generator, neftune_alpha, noise)
    hidden = core.forward(params, cfg, inputs_embeds=embeds, mask=attn, lora=lora, lora_scale=lora_scale,
                          remat=remat)
    return _next_token_nll(hidden, params, cfg, tokens, loss_weights(loss_mask), weight_total)


def packed_sft_loss(lora: Dict, params: Dict, cfg: TransformerConfig, tokens: torch.Tensor,
                    loss_mask: torch.Tensor, segment_ids: torch.Tensor, generator: Optional[torch.Generator], *,
                    lora_scale: float, neftune_alpha: float = 0.0, remat: bool = True,
                    noise: Optional[torch.Tensor] = None, weight_total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sft_loss`` over packed rows: attention causal and within a segment,
    positions restarting at each segment, a target scored only where it
    continues its segment."""
    B, T = tokens.shape
    dev = tokens.device
    seg = segment_ids.to(dev).long()
    attn = (causal_mask(T, T, device=dev) & (seg[:, None, :, None] == seg[:, None, None, :])
            & (seg > 0)[:, None, None, :])
    idx = torch.arange(T, device=dev)[None, :].expand(B, T)
    change = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev), seg[:, 1:] != seg[:, :-1]], dim=1)
    seg_start = torch.cummax(torch.where(change, idx, torch.zeros_like(idx)), dim=1).values
    embeds = _embed(params, cfg, tokens, generator, neftune_alpha, noise)
    hidden = core.forward(params, cfg, inputs_embeds=embeds, positions=idx - seg_start, mask=attn, lora=lora,
                          lora_scale=lora_scale, remat=remat)
    return _next_token_nll(hidden, params, cfg, tokens, loss_weights(loss_mask, seg), weight_total)


def mesh_norm(cfg: TransformerConfig, mesh):
    """The global norm of a LoRA-shaped tree (gradients, their running
    mean) sharded under ``mesh``: a leaf narrower than its full shape
    (``transformer.proj_shapes``) adds its squares summed over the model
    group, a whole one its own squares once."""
    full = core.proj_shapes(cfg)

    def norm(tree):
        cut, whole = [], []
        for name, g in tree["layers"].items():
            fi, fo = full[name[:-7]]
            want = (fi, g.shape[-1]) if name.endswith("_lora_a") else (g.shape[-2], fo)
            (whole if tuple(g.shape[-2:]) == want else cut).append(torch.sum(g.float() * g.float()))
        zero = torch.zeros((), device=next(iter(tree["layers"].values())).device)
        return torch.sqrt(comm.reduce_model(sum(cut, zero), mesh) + sum(whole, zero))

    return norm


def make_optimizer(tcfg: TrainConfig, total_steps: int) -> GradientTransformation:
    """Clip to global norm 1, AdamW without weight decay, the learning rate
    linear to 0 over ``total_steps`` (or constant)."""
    sched = (linear_schedule(tcfg.learning_rate, 0.0, max(total_steps, 1)) if tcfg.lr_schedule == "linear"
             else tcfg.learning_rate)
    return chain(clip_by_global_norm(1.0), adamw(sched, b1=0.9, b2=0.999, weight_decay=0.0))


def make_train_step(cfg: TransformerConfig, tcfg: TrainConfig, optimizer, packed: Optional[bool] = None,
                    mesh=None):
    """One SFT step: ``train_step(lora, opt_state, params, tokens,
    loss_mask, aux, generator, noise=None) -> (lora, opt_state, loss)``;
    ``aux`` is ``length`` [B] unpacked or ``segment_ids`` [B, T] packed
    (``packed=None`` follows ``tcfg.packing``). Under ``mesh`` the batch is
    the global one and ``lora`` / ``opt_state`` / ``params`` this rank's
    slices (module docstring); the loss returned is the global batch's."""
    lora_scale = tcfg.lora.alpha / tcfg.lora.r
    is_packed = tcfg.packing if packed is None else packed
    loss_fn = packed_sft_loss if is_packed else sft_loss
    norm = None if mesh is None else mesh_norm(cfg, mesh)

    def train_step(lora, opt_state, params, tokens, loss_mask, aux, generator, noise=None):
        total = None
        if mesh is not None:
            B, T = tokens.shape
            rows = batch_sharding(mesh, B)
            if tcfg.neftune_alpha > 0 and noise is None:   # the whole batch's draw
                noise = neftune_noise(generator, (B, T, cfg.dim), tokens.device)
            tokens, loss_mask, aux = tokens[rows], loss_mask[rows], aux[rows]
            noise = None if noise is None else noise[rows]
            w = loss_weights(loss_mask, aux if is_packed else None).sum()
            total = torch.clamp(comm.reduce_data(w, mesh), min=1.0)
        with nullcontext() if mesh is None else mesh:
            loss, _, grads = value_and_grad(
                lambda lo: loss_fn(lo, params, cfg, tokens, loss_mask, aux, generator, lora_scale=lora_scale,
                                   neftune_alpha=tcfg.neftune_alpha, remat=tcfg.remat, noise=noise,
                                   weight_total=total), lora)
        if mesh is not None:
            grads = tree_map(lambda g: comm.reduce_data(g, mesh), grads)
            loss = comm.reduce_data(loss, mesh)
        with nullcontext() if norm is None else sharded_norm(norm):
            lora, opt_state = apply_optimizer(train_step, optimizer, lora, grads, opt_state)
        return lora, opt_state, loss

    return train_step


# ----------------------------------------------------------------------- eval (weighted F1)


def weighted_f1(y_true: List[str], y_pred: List[str], labels: List[str]) -> float:
    """Generation-based weighted F1 (the reference's metric)."""
    f1_sum, n = 0.0, len(y_true)
    for lab in labels:
        tp = sum(1 for t, p in zip(y_true, y_pred) if t == lab and p == lab)
        fp = sum(1 for t, p in zip(y_true, y_pred) if t != lab and p == lab)
        fn = sum(1 for t, p in zip(y_true, y_pred) if t == lab and p != lab)
        support = tp + fn
        if support == 0:
            continue
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / support
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        f1_sum += f1 * support
    return f1_sum / max(n, 1)


def match_label(pred_text: str, labels: List[str]) -> str:
    """Generated text -> a label: the first the text starts with, else the
    first it contains, else ''."""
    pred_text = pred_text.strip().lower()
    for lab in labels:
        if pred_text.startswith(lab.lower()):
            return lab
    for lab in labels:
        if lab.lower() in pred_text:
            return lab
    return ""


@torch.no_grad()
def evaluate_generation(params: Dict, cfg: TransformerConfig, samples: List[dict], labels: List[str],
                        lora: Optional[Dict] = None, lora_scale: float = 0.0, batch_size: int = 8,
                        max_prompt: int = 768, max_new: int = 10) -> Tuple[float, List[str]]:
    """Greedy ``max_new``-token generation per sample -> (weighted F1,
    predictions). Batches are left-padded to ``max_prompt`` and the ragged
    tail repeats its last sample, so one cache serves every batch."""
    dev = params["tok_emb"].device
    y_true = [s["messages"][-1]["content"] for s in samples]
    preds: List[str] = []
    cache = None
    for s0 in range(0, len(samples), batch_size):
        chunk = samples[s0 : s0 + batch_size]
        n_real = len(chunk)
        chunk = chunk + [chunk[-1]] * (batch_size - n_real)
        prompts = [render_chat(s["messages"][:-1], add_generation_prompt=True)[0][-max_prompt:] for s in chunk]
        toks, lens = core.left_pad(prompts, pad_id=frontend.PAD_ID, width=max_prompt)
        if cache is None:
            cache = core.make_cache(cfg, batch_size, max_prompt + max_new + 1, dev,
                                    n_kv_heads=core.local_heads(params, cfg)[1])
        res = core.generate(params, cfg, torch.as_tensor(toks, device=dev), torch.as_tensor(lens, device=dev),
                            cache, None, max_new_tokens=max_new, sampler=SamplerConfig.label(), eos_id=END,
                            pad_id=frontend.PAD_ID, lora=lora, lora_scale=lora_scale)
        cache = res.cache
        for row in res.tokens.cpu().numpy()[:n_real]:
            preds.append(match_label(decode_assistant(row), labels))
    return weighted_f1(y_true, preds, labels), preds


# ----------------------------------------------------------------------- the training loop


def train(params: Dict, cfg: TransformerConfig, tcfg: TrainConfig, train_samples: List[dict],
          eval_samples: Optional[List[dict]] = None, labels: Optional[List[str]] = None,
          out_dir: str = "./finetuned_llm", log_every: int = 50, log=print) -> Dict:
    """The SFT loop: packing where it pays, gradient accumulation, the
    linear schedule over applied steps, eval and save every N steps, the
    best adapter by F1 in ``best.npz``, resume (adapter and optimizer state)
    from the latest checkpoint. The LoRA is drawn from ``PRNGKey(tcfg.seed)``
    as the JAX ``train`` draws it; NEFTune's noise from a generator seeded
    with ``tcfg.seed``, both on the base's device."""
    dev = params["tok_emb"].device
    generator = torch.Generator(device=dev).manual_seed(tcfg.seed)
    lora = core.init_lora(cfg, tcfg.lora.r, rng.PRNGKey(tcfg.seed, dev))
    rendered = render_samples(train_samples, tcfg.max_seq_len)

    packing = tcfg.packing
    if packing:
        n_packed = packed_row_count(rendered, tcfg.max_seq_len)
        reduction = len(rendered) / max(n_packed, 1)
        if reduction < 1.1:
            packing = False
            log(f"[lora_sft] packing auto-disabled: FFD step reduction {reduction:.2f}x < 1.1x on this corpus "
                f"({len(rendered)} samples -> {n_packed} packed rows at seq{tcfg.max_seq_len})")

    def epoch_batches(epoch: int) -> Iterator:
        if packing:
            return make_packed_batches(train_samples, tcfg.max_seq_len, tcfg.batch_size, seed=tcfg.seed + epoch,
                                       pad_to_batch=True, rendered=rendered)
        return make_batches(train_samples, tcfg.max_seq_len, tcfg.batch_size, seed=tcfg.seed + epoch,
                            drop_last=True, rendered=rendered)

    micro_per_epoch = sum(1 for _ in epoch_batches(0))
    steps_per_epoch = max(1, micro_per_epoch // tcfg.grad_accum)
    total_steps = steps_per_epoch * tcfg.epochs
    optimizer = MultiSteps(make_optimizer(tcfg, total_steps), every_k_schedule=tcfg.grad_accum)
    opt_state = optimizer.init(lora)
    step_fn = make_train_step(cfg, tcfg, optimizer, packed=packing)
    mgr = CheckpointManager(out_dir, save_total_limit=1)
    best_path = Path(out_dir) / "best.npz"

    start = mgr.latest_step() or 0
    if start:
        state = mgr.restore({"lora": lora, "opt_state": opt_state}, step=start)
        lora, opt_state = state["lora"], state["opt_state"]

    best_f1, best_step, step = -1.0, start, start
    history = []
    from ..utils.tb_events import EventWriter

    tb = EventWriter(Path(out_dir) / "tb")
    lora_scale = tcfg.lora.alpha / tcfg.lora.r
    done = step >= total_steps
    for epoch in range(tcfg.epochs):
        if done:
            break
        micro = 0
        for batch in epoch_batches(epoch):
            aux = batch.segment_ids if packing else batch.length
            lora, opt_state, loss = step_fn(lora, opt_state, params, torch.as_tensor(batch.tokens, device=dev),
                                            torch.as_tensor(batch.loss_mask, device=dev),
                                            torch.as_tensor(aux, device=dev), generator)
            micro += 1
            if micro % tcfg.grad_accum:
                continue
            step += 1
            if step % log_every == 0:
                history.append({"step": step, "loss": float(loss)})
                tb.scalar("train/loss", float(loss), step)
                tb.flush()
                log(f"[lora_sft] step {step}/{total_steps} loss {history[-1]['loss']:.4f}")
            if eval_samples and labels and step % tcfg.eval_every == 0:
                f1, _ = evaluate_generation(params, cfg, eval_samples, labels, lora=lora, lora_scale=lora_scale)
                history.append({"step": step, "eval_weighted_f1": f1})
                tb.scalar("eval/weighted_f1", f1, step)
                if f1 > best_f1:
                    best_f1, best_step = f1, step
                    save_pytree(best_path, lora, metadata={"f1": f1, "step": step})
            if step % tcfg.save_every == 0:
                mgr.save(step, {"lora": lora, "opt_state": opt_state}, metadata={"best_f1": best_f1})
            if step >= total_steps:
                done = True
                break
    mgr.save(max(step, 1), {"lora": lora, "opt_state": opt_state}, metadata={"best_f1": best_f1, "final": True})
    if best_f1 < 0 and not best_path.exists():
        save_pytree(best_path, lora, metadata={"step": step})
    tb.close()
    Path(out_dir, "history.json").write_text(json.dumps(history, indent=2))
    return {"lora": lora, "best_f1": best_f1, "best_step": best_step, "steps": step, "history": history,
            "best_checkpoint": str(best_path), "packing": packing}


# ----------------------------------------------------------------------- multi-device dry run


def _dryrun_setup(n_devices: int, device):
    """The JAX dry run's geometry and batch: a 64-wide, 2-layer GQA (4:2)
    f32 embedder, the base from ``PRNGKey(0)``, the LoRA from
    ``PRNGKey(1)``, ``n_devices`` packed rows of 32 tokens, two segments a
    row and a pad tail."""
    cfg = TransformerConfig(vocab_size=frontend.VOCAB_SIZE, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                            ffn_dim=128, max_seq_len=64, dtype="float32")
    tcfg = TrainConfig(batch_size=n_devices, grad_accum=1, max_seq_len=32)
    params = core.init_params(cfg, rng.PRNGKey(0, device))
    lora = core.init_lora(cfg, tcfg.lora.r, rng.PRNGKey(1, device))
    r = np.random.default_rng(0)
    B, T = tcfg.batch_size, tcfg.max_seq_len
    tokens = r.integers(16, 272, (B, T)).astype(np.int32)
    loss_mask = (r.random((B, T)) > 0.5).astype(np.int32)
    seg = np.zeros((B, T), np.int32)
    seg[:, : T // 2] = 1
    seg[:, T // 2 : T - 4] = 2
    loss_mask[:, T - 4 :] = 0
    batch = [torch.as_tensor(a, device=device) for a in (tokens, loss_mask, seg)]
    return cfg, tcfg, params, lora, batch


def _dryrun_step(cfg, tcfg, params, lora, batch, device, mesh=None):
    """One packed step (NEFTune noise from a generator seeded 2) ->
    (loss, the updated LoRA: this rank's slices under ``mesh``)."""
    from ..parallel.sharding import shard_params

    heads = (cfg.n_heads, cfg.n_kv_heads)
    if mesh is not None:
        params, lora = shard_params(mesh, params, heads), shard_params(mesh, lora, heads)
    opt = make_optimizer(tcfg, 10)
    step = make_train_step(cfg, tcfg, opt, packed=True, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(2)
    lora2, _, loss = step(lora, opt.init(lora), params, *batch, gen)
    return float(loss), lora2


def dryrun_train_step_rank(n_devices: int, model: int, device: str, backend: Optional[str]):
    """One rank of ``dryrun_train_step``: its mesh, the sharded step, the
    updated LoRA gathered; rank 0 returns (mesh shape, loss, LoRA as
    numpy), the others (mesh shape, loss, None)."""
    from ..parallel.mesh import make_mesh
    from ..parallel.sharding import gather_params

    mesh = make_mesh(n_devices // model, model, device=device, backend=backend)
    cfg, tcfg, params, lora, batch = _dryrun_setup(n_devices, mesh.device)
    loss, lora2 = _dryrun_step(cfg, tcfg, params, lora, batch, mesh.device, mesh)
    full = gather_params(mesh, lora2, like=lora, heads=(cfg.n_heads, cfg.n_kv_heads))
    host = tree_map(lambda t: t.detach().cpu().numpy(), full) if mesh.rank == 0 else None
    return mesh.shape, loss, host


DRYRUN_ATOL = 1e-5     # the sharded step's loss and updated LoRA against the unsharded step's


def dryrun_train_step(n_devices: int, *, device=None, backend: Optional[str] = None) -> dict:
    """The JAX package's multi-device dry run: ONE packed SFT step at tiny
    geometry over an ``n_devices`` mesh (model 2 where n is even, as JAX
    picks it), on ``n_devices`` spawned ranks (``parallel.launch``; one
    device shared, ``gloo`` unless ``backend`` names one), checked against
    the unsharded step in this process: the loss and the updated LoRA
    within ``DRYRUN_ATOL``. Prints the ``dryrun_multichip ok`` line and returns
    the numbers."""
    from ..parallel.launch import launch
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    backend = backend or "gloo"
    model = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    out = launch(dryrun_train_step_rank, n_devices, n_devices, model, str(dev), backend, backend=backend)
    shape, loss, got = out[0]
    cfg, tcfg, params, lora, batch = _dryrun_setup(n_devices, dev)
    ref_loss, ref = _dryrun_step(cfg, tcfg, params, lora, batch, dev)
    if not all(abs(o[1] - ref_loss) <= DRYRUN_ATOL for o in out):
        raise AssertionError(f"dry run losses {[o[1] for o in out]} != unsharded {ref_loss}")
    err = max(float(np.abs(g - r.detach().cpu().numpy()).max())
              for g, r in zip(tree_leaves(got), tree_leaves(ref)))
    if not np.isfinite(loss) or err > DRYRUN_ATOL:
        raise AssertionError(f"dry run LoRA differs from the unsharded step by {err}")
    print(f"dryrun_multichip ok: mesh=({shape}), loss={loss:.4f}, unsharded={ref_loss:.4f}, lora_err={err:.2e}")
    return {"mesh": shape, "loss": loss, "unsharded_loss": ref_loss, "lora_max_abs_err": err}

