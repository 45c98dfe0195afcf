"""Train the framework BPE vocab (models/bpe.py) on text corpora.

Inputs: plain .txt (one utterance per line), .jsonl with a text field, or
the IEMOCAP conversation JSON ({conv_id: {sentences: [...]}}). Counterpart
of the JAX ``cli/train_bpe.py`` (the same merges for the same inputs). The
merges JSON it writes loads in either package: in the TTS engine
(--set frontend.tokenizer=bpe --set frontend.bpe_path=...) and the embedder
(--bpe_path on the retrieval CLIs).

  python -m autostyle_tts_tpu_torch.cli.train_bpe \\
      --input data/iemocap.train.json --output vocab/bpe4k.json --merges 4096
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Iterator, List

from ..models.bpe import BPETokenizer, train_bpe, train_bpe_zh


def iter_texts(paths: List[str], text_keys=("zh_text", "text", "sentence")) -> Iterator[str]:
    for path in paths:
        p = Path(path)
        if p.suffix == ".txt":
            for line in p.read_text(encoding="utf-8").splitlines():
                if line.strip():
                    yield line.strip()
            continue
        raw = p.read_text(encoding="utf-8")
        if p.suffix == ".jsonl" or "\n{" in raw[:2000]:
            for line in raw.splitlines():
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                for k in text_keys:
                    if isinstance(obj.get(k), str):
                        yield obj[k]
                        break
            continue
        obj = json.loads(raw)
        if isinstance(obj, dict):
            for conv in obj.values():
                if isinstance(conv, dict) and isinstance(
                    conv.get("sentences"), list
                ):
                    yield from (s for s in conv["sentences"]
                                if isinstance(s, str))
        elif isinstance(obj, list):
            for item in obj:
                if isinstance(item, dict):
                    for k in text_keys:
                        if isinstance(item.get(k), str):
                            yield item[k]
                            break


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", type=str, nargs="+", required=True)
    p.add_argument("--output", type=str, required=True)
    p.add_argument("--merges", type=int, default=4096)
    p.add_argument("--zh_merges", type=int, default=0,
                   help="also learn merges over the CJK/kana plane ids "
                        "(word-level ZH compression on top of the 1-char="
                        "1-token plane)")
    args = p.parse_args(argv)

    texts = list(iter_texts(args.input))
    if not texts:
        raise SystemExit("no training text found in inputs")
    tok = train_bpe(texts, n_merges=args.merges)
    if args.zh_merges:
        zh = train_bpe_zh(texts, n_merges=args.zh_merges,
                          n_base_merges=len(tok.merges))
        tok = BPETokenizer(tok.merges, zh)
    tok.save(args.output)
    # quick stats: compression vs bytes on the training text; for ZH also
    # chars/token (the plane alone gives exactly 1.0)
    total_bytes = sum(len(t.encode("utf-8")) for t in texts)
    total_tokens = sum(len(tok.encode_segment(t)) for t in texts)
    zh_chars = sum(1 for t in texts for c in t if 0x3040 <= ord(c) <= 0x9FFF)
    zh_tokens = sum(
        len([i for i in tok.encode_segment(t) if i >= 8464 or (
            272 + len(tok.merges) <= i < 8464)])
        for t in texts
    )
    print(json.dumps({
        "texts": len(texts), "merges": len(tok.merges),
        "zh_merges": len(tok.zh_merges),
        "bytes_per_token": round(total_bytes / max(total_tokens, 1), 3),
        "zh_chars_per_token": round(zh_chars / max(zh_tokens, 1), 3),
        "output": args.output,
    }))


if __name__ == "__main__":
    from .common import run_cli

    run_cli(main)
