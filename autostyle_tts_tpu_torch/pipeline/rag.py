"""RAG layer: the style-embedder service, the style-DB build and dialog search.

Counterpart of the JAX ``pipeline/rag.py``:

- ``EmbedderService.embed``: mean-pooled last-hidden-layer text embedding,
  512-token truncation;
- ``EmbedderService.biographies``: one sampled generation a speaker
  (T=0.7, top-p 0.9, 250 new tokens);
- ``EmbedderService.emotion_labels``: a greedy 10-token generation matched
  against the label set, through the plain prompt or the ERC fine-tune's
  chat format (``pipeline/erc_chat.py``);
- ``combined_embedding``: concat(emb(emotion label), emb(biography)),
  3072 || 3072 = 6144 at the Llama-3.2-3B width;
- ``build_style_db``: biographies, labels, combined embeddings, insert,
  self-verify, and the prompt artifacts (``prompt_artifacts``);
- ``search_dialog``: the query path, with the ``emotion_only`` /
  ``bio_only`` ablations and a ±N-turn labelling context.

Batches are chunked to the reference's device budget
(``GEN_KV_BUDGET_BYTES``). The reference also pads each batch to a power of
two so that its compiled programs are reused; the port runs eagerly and
does not (no real row changes). The service runs on the card unless
``device="cpu"``; there every kernel wrapper takes its plain version.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import islice
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import frontend
from ..models import transformer as core
from ..ops.sampling import SamplerConfig
from ..retrieval.store import StyleStore
from ..utils.audio_io import load_wav
from ..utils.config import TransformerConfig
from ..utils.device import DeviceLike, resolve_device
from ..utils.manifest import RetrievalRow, StyleSample, group_by_speaker
from ..weights import to_device
from . import erc_chat
from .engine import Engine

# the reference's prompts, carried over as data
BIOGRAPHY_PROMPT = """
Given this conversation between speakers:
"
{conversation}
"
In overall of above conversation, what do you think about the characteristics of speaker {speaker}? (Note: provide an answer within 250 words)
"""

EMOTION_PROMPT = """\n=======
Context: Given predefined emotional label set [{labels}], and below conversation:
"
{conversation}
"

Question: What is the emotion of the speaker at the utterance "{text}"?
Answer:"""

EMOTION_LABELS_EN = ["happy", "sad", "neutral", "angry", "excited", "frustrated"]
# the ZH label set (7 labels with fear and surprise), the one the ZH trainer uses
EMOTION_LABELS_ZH = ["快乐", "中性", "悲伤", "厌恶", "愤怒", "恐惧", "惊讶"]


def labels_for_language(language: str) -> List[str]:
    return list(EMOTION_LABELS_EN if language == "en" else EMOTION_LABELS_ZH)


EMBED_MAX_TOKENS = 512       # truncation of an embedded text
BIO_MAX_NEW = 250            # new tokens of a biography
EMOTION_MAX_NEW = 10         # new tokens of an emotion label
# Per-call activation / KV budget: embed() and _generate_ids() chunk their
# batches to stay under it (at the 3B width: 32 rows an embed call, 8 a
# biography call, 16 / 8 a label call at prompt width 512 / 768)
GEN_KV_BUDGET_BYTES = 1_250_000_000
PLACEHOLDER_BIO = "This is a placeholder biography."


class EmbedderService:
    """Batched embedding and generation on the transformer core."""

    def __init__(
        self,
        cfg: TransformerConfig,
        params: Dict,
        lora: Optional[Dict] = None,
        lora_scale: float = 0.0,
        labels: Sequence[str] = tuple(EMOTION_LABELS_EN),
        tokenizer=None,
        erc_chat="auto",
        language: str = "en",
        device: DeviceLike = None,
    ):
        """``tokenizer``: None (the byte frontend), a ``models.bpe.BPETokenizer``
        (truncation then counts its tokens) or an object with the Hugging
        Face tokenizer interface, whose ids index ``params``' embedding.
        ``erc_chat``: label emotions through the ERC fine-tune's chat format
        instead of the plain prompt; "auto" turns it on exactly when an
        adapter rides the byte frontend (the format is a byte-plane one).
        ``params`` and ``lora`` move to ``device`` (the card unless "cpu");
        sampled generations draw from ``self.generator`` (seeded with 0,
        where the reference holds ``PRNGKey(0)``)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = to_device(params, self.device)
        self.lora = None if lora is None else to_device(lora, self.device)
        self.lora_scale = lora_scale
        self.labels = list(labels)
        self.language = language
        self.erc_chat = (lora is not None and tokenizer is None) if erc_chat == "auto" else bool(erc_chat)
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self._frontend_bpe = hasattr(tokenizer, "encode_segment")
        self.tokenizer = tokenizer
        if self._frontend_bpe and cfg.vocab_size < tokenizer.vocab_size:
            raise ValueError(f"embedder vocab_size={cfg.vocab_size} < BPE vocab {tokenizer.vocab_size}")
        if tokenizer is None or self._frontend_bpe:
            self.pad_id, self.eos_id = frontend.PAD_ID, frontend.EOS_ID
        else:
            pad = tokenizer.pad_token_id  # 0 is a legitimate pad id
            self.pad_id = pad if pad is not None else (tokenizer.eos_token_id or 0)
            self.eos_id = tokenizer.eos_token_id

    # ------------------------------------------------------------------ tokenization

    def _encode(self, text: str, max_len: int) -> np.ndarray:
        if self.tokenizer is None or self._frontend_bpe:
            return frontend.encode(text, add_eos=False, tokenizer=self.tokenizer)[:max_len]
        return np.asarray(self.tokenizer.encode(text)[:max_len], np.int32)

    def _decode(self, ids) -> str:
        if self.tokenizer is None or self._frontend_bpe:
            return frontend.decode(ids, tokenizer=self.tokenizer)
        return self.tokenizer.decode([int(i) for i in ids], skip_special_tokens=True)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------ embeddings

    def embed(self, texts: List[str], width: int = EMBED_MAX_TOKENS) -> np.ndarray:
        """[B] texts -> [B, dim] f32 mean-pooled last-hidden embeddings,
        each text truncated to ``width`` tokens and right-padded to it."""
        # chunked so the forward's temporaries (~8 live [B, T, D] bf16
        # copies through the layer stack) stay under the budget
        row_bytes = width * self.cfg.dim * 2 * 8
        cap = 1
        while cap < 256 and cap * 2 * row_bytes <= GEN_KV_BUDGET_BYTES:
            cap *= 2
        if len(texts) > cap:
            return np.concatenate([self.embed(texts[s0 : s0 + cap], width=width)
                                   for s0 in range(0, len(texts), cap)], axis=0)
        seqs = [self._encode(t, width) for t in texts]
        lens = np.asarray([len(s) for s in seqs], np.int32)
        ids = np.full((len(texts), width), self.pad_id, np.int32)
        for i, s in enumerate(seqs):
            ids[i, : len(s)] = s
        mask = (np.arange(width)[None, :] < lens[:, None]).astype(np.int32)
        out = core.embed_text(self.params, self.cfg, self._tensor(ids), self._tensor(mask),
                              lora=self.lora, lora_scale=self.lora_scale)
        return out.cpu().numpy().astype(np.float32)

    def combined_embedding(self, emotion_texts: List[str], biography_texts: List[str]) -> np.ndarray:
        """concat(emb(emotion), emb(bio)) -> [B, 2*dim] (6144 at 3B); both
        halves in one embed batch."""
        both = self.embed(list(emotion_texts) + list(biography_texts))
        n = len(emotion_texts)
        return np.concatenate([both[:n], both[n:]], axis=-1)

    # ------------------------------------------------------------------ generation

    def _generate(self, prompts: List[str], max_new: int, sampler: SamplerConfig,
                  prompt_width: int = 1024) -> List[str]:
        seqs = [self._encode(p, 10 ** 9)[-prompt_width:] for p in prompts]
        return self._generate_ids(seqs, max_new, sampler, prompt_width)

    def _generate_ids(self, seqs, max_new: int, sampler: SamplerConfig, prompt_width: int,
                      eos_id=None, decode_fn=None) -> List[str]:
        # chunked so each call's KV cache stays under the budget
        row_bytes = (self.cfg.n_layers * (prompt_width + max_new + 1)
                     * self.cfg.n_kv_heads * self.cfg.head_dim * 2 * 2)   # bf16, k and v
        cap = 1
        while cap < 64 and cap * 2 * row_bytes <= GEN_KV_BUDGET_BYTES:
            cap *= 2
        if len(seqs) > cap:
            out: List[str] = []
            for s0 in range(0, len(seqs), cap):
                out.extend(self._generate_ids(seqs[s0 : s0 + cap], max_new, sampler, prompt_width,
                                              eos_id=eos_id, decode_fn=decode_fn))
            return out
        toks, lens = core.left_pad(seqs, pad_id=self.pad_id, width=prompt_width)
        cache = core.make_cache(self.cfg, len(seqs), prompt_width + max_new + 1, self.device)
        res = core.generate(self.params, self.cfg, self._tensor(toks), self._tensor(lens), cache,
                            self.generator, max_new_tokens=max_new, sampler=sampler,
                            eos_id=self.eos_id if eos_id is None else eos_id, pad_id=self.pad_id,
                            lora=self.lora, lora_scale=self.lora_scale)
        decode = decode_fn or self._decode
        return [decode(row[: int(n)]).strip()
                for row, n in zip(res.tokens.cpu().numpy(), res.lengths.cpu().numpy())]

    def biography(self, conversation: str, speaker: str) -> str:
        return self.biographies([(conversation, speaker)])[0]

    def biographies(self, items: List[Tuple[str, str]]) -> List[str]:
        prompts = [BIOGRAPHY_PROMPT.format(conversation=c, speaker=s) for c, s in items]
        return self._generate(prompts, BIO_MAX_NEW, SamplerConfig.biography())

    def emotion_label(self, text: str) -> str:
        return self.emotion_labels([text])[0]

    def _erc_chat_labels_raw(self, texts: List[str], contexts=None, names=None) -> List[str]:
        """Labels through the fine-tune's own chat format: the system and
        user messages and the byte-plane template the adapter trained on."""
        P = erc_chat._PROMPTS[self.language]
        width = 768 if contexts else 512
        seqs = []
        for i, t in enumerate(texts):
            name = names[i] if names else "A"
            ctx = contexts[i] if contexts and contexts[i] else f" {name}: {t}"
            ids, _ = erc_chat.render_chat(
                [{"role": "system", "content": P["system"] + P["context"].format(ctx=ctx)},
                 {"role": "user", "content": P["question_default"].format(name=name, sent=t)}],
                add_generation_prompt=True)
            seqs.append(ids[-width:])
        return self._generate_ids(seqs, EMOTION_MAX_NEW, SamplerConfig.label(), width,
                                  eos_id=erc_chat.END, decode_fn=erc_chat.decode_assistant)

    def emotion_labels(self, texts: List[str], contexts=None, names=None) -> List[str]:
        """Per-utterance emotion labels. ``contexts`` / ``names``: optional
        surrounding-dialog windows and speaker names a text (the shape of
        the fine-tune's training prompts)."""
        if self.erc_chat:
            raw = self._erc_chat_labels_raw(texts, contexts, names)
        else:
            prompts = [EMOTION_PROMPT.format(labels=", ".join(self.labels),
                                             conversation=contexts[i] if contexts and contexts[i] else t,
                                             text=t)
                       for i, t in enumerate(texts)]
            raw = self._generate(prompts, EMOTION_MAX_NEW, SamplerConfig.label(), prompt_width=512)
        out = []
        for r in raw:
            r = r.strip().lower()
            match = next((l for l in self.labels if r.startswith(l.lower())), None)
            match = match or next((l for l in self.labels if l.lower() in r), None)
            out.append(match or "neutral")  # the reference's default when nothing matches
        return out


# ----------------------------------------------------------------------- DB build


def prompt_artifacts(engine: Engine, wavs: Iterable[np.ndarray], batch: int = 16) -> Dict[str, np.ndarray]:
    """Featurize 16 kHz style wavs (arrays, row i of the DB first; read from
    the iterable ``batch`` at a time) and pack them as
    ``StyleStore.artifacts``: ``speech_tokens`` [n, T_tok] /
    ``speech_token_lens``, ``prompt_mel`` [n, F, M] / ``prompt_mel_lens``,
    ``spk`` [n, spk_dim], right-padded with zeros."""
    feats = []
    it = iter(wavs)
    # chunked as the embedding loop is: one [n, 30 s] device batch for a
    # large corpus would not fit
    while chunk := list(islice(it, batch)):
        feats.extend(engine.prompt_features(chunk))
    n = len(feats)
    T_tok = max(len(f.tokens) for f in feats)
    F_mel = max(f.mel24.shape[0] for f in feats)
    tokens = np.zeros((n, T_tok), np.int32)
    tok_lens = np.zeros((n,), np.int32)
    mels = np.zeros((n, F_mel, feats[0].mel24.shape[1]), np.float32)
    mel_lens = np.zeros((n,), np.int32)
    spks = np.zeros((n, feats[0].spk.shape[0]), np.float32)
    for i, f in enumerate(feats):
        tokens[i, : len(f.tokens)] = f.tokens
        tok_lens[i] = len(f.tokens)
        mels[i, : f.mel24.shape[0]] = f.mel24
        mel_lens[i] = f.mel24.shape[0]
        spks[i] = f.spk
    return {"speech_tokens": tokens, "speech_token_lens": tok_lens,
            "prompt_mel": mels, "prompt_mel_lens": mel_lens, "spk": spks}


def build_style_db(embedder: EmbedderService, samples: List[StyleSample], capacity: int = 4096,
                   batch: int = 16, engine: Optional[Engine] = None, wav_dir: str = "") -> StyleStore:
    """The insert pipeline: one biography a speaker from the speaker's
    utterances, an emotion label an utterance, the combined 2*dim
    embedding, insert, self-verify (each batch as written, then every row).
    With ``engine``, each sample's style wav (wav_dir/file_id[.wav]) is
    featurized and its speech tokens, prompt mel and speaker embedding land
    in the DB as artifacts, so serving loads no wav. The store lives on the
    embedder's device."""
    by_speaker = group_by_speaker(samples)
    spk_items = [("\n".join(s.zh_text for s in group), spk) for spk, group in by_speaker.items()]
    bios = dict(zip((spk for _, spk in spk_items), embedder.biographies(spk_items)))

    store = StyleStore(dim=2 * embedder.cfg.dim, capacity=capacity, device=embedder.device)
    for s0 in range(0, len(samples), batch):
        chunk = samples[s0 : s0 + batch]
        emotions = embedder.emotion_labels([s.zh_text for s in chunk])
        vecs = embedder.combined_embedding(emotions, [bios[s.speaker] for s in chunk])
        store.insert(vecs, [{"file_id": s.file_id, "text": s.zh_text, "speaker": s.speaker, "emotion": e}
                            for s, e in zip(chunk, emotions)])
        if not store.self_verify(sample=len(chunk)):
            raise RuntimeError(f"style DB self-verification failed for insert batch at {s0}")
    if not store.self_verify():
        raise RuntimeError("style DB self-verification failed (top-1 != self)")

    if engine is not None:
        sr = engine.cfg.audio.prompt_sample_rate
        paths = (Path(wav_dir) / (s.file_id if s.file_id.endswith(".wav") else s.file_id + ".wav")
                 for s in samples)
        store.artifacts = prompt_artifacts(engine, (load_wav(p, sr) for p in paths), batch)
    return store


# ----------------------------------------------------------------------- query


@dataclass
class DialogTurn:
    zh_text: str
    speaker: str


def search_dialog(
    embedder: EmbedderService,
    store: StyleStore,
    turns: List[DialogTurn],
    conversations_by_speaker: Optional[Dict[str, str]] = None,
    top_k: int = 1,
    file_prefix_path: str = "",
    ablation: Optional[str] = None,    # None | "emotion_only" | "bio_only"
    batch: int = 16,
    context_window: int = 0,
) -> List[RetrievalRow]:
    """The query path: one biography a speaker, an emotion label a turn,
    the combined query, top-k search, one ``RetrievalRow`` a turn.

    The ablations zero one half of the query and L2-normalize it.
    ``context_window``: label each turn with the ±N surrounding turns as
    context (0: each utterance alone, as the reference's search does; >0:
    the shape of the ERC fine-tune's training prompts)."""
    speakers = sorted({t.speaker for t in turns})
    convs = conversations_by_speaker or {
        spk: "\n".join(t.zh_text for t in turns if t.speaker == spk) for spk in speakers}
    bios = dict(zip(speakers, embedder.biographies([(convs[s], s) for s in speakers])))

    ctxs_all = None
    if context_window:
        lines = [f" {t.speaker}: {t.zh_text}" for t in turns]
        ctxs_all = ["\n".join(lines[max(0, i - context_window) : i + context_window + 1])
                    for i in range(len(turns))]

    rows: List[RetrievalRow] = []
    for s0 in range(0, len(turns), batch):
        chunk = turns[s0 : s0 + batch]
        emotions = embedder.emotion_labels(
            [t.zh_text for t in chunk],
            contexts=ctxs_all[s0 : s0 + batch] if ctxs_all else None,
            names=[t.speaker for t in chunk] if ctxs_all else None)
        q = embedder.combined_embedding(emotions, [bios.get(t.speaker, PLACEHOLDER_BIO) for t in chunk])
        half = q.shape[1] // 2
        if ablation == "emotion_only":
            q[:, half:] = 0.0
        elif ablation == "bio_only":
            q[:, :half] = 0.0
        if ablation in ("emotion_only", "bio_only"):
            q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        for t, hl in zip(chunk, store.search(q, k=top_k)):
            if not hl:
                rows.append(RetrievalRow(t.zh_text, t.speaker, "N/A", "N/A", 0.0))
                continue
            h = hl[0]
            fid = h.file_id
            if file_prefix_path:
                fid = file_prefix_path.rstrip("/") + "/" + fid.lstrip("/")
            rows.append(RetrievalRow(zh_text=t.zh_text, speaker=t.speaker, retrieved_file_id=fid,
                                     retrieved_text=h.text, distance=h.distance, retrieved_index=h.index))
    return rows
