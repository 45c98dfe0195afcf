"""ERC dataset reformatter: conversation JSON -> chat-format JSONL.

The port's own copy of the JAX ``train/reformat.py`` (pure Python; the
same inputs give the same rows; the prompt wording is ``pipeline/erc_chat.py``'s,
which the embedder serves): both language variants of the reference's
reformatters, their label maps, speaker-name maps and prompt wording, the
``default`` and ``spdescV2`` prompting and the +-window context.

Input schema per conversation id: {labels: [int], sentences: [str],
genders: [str], speakers?: [str]}. Output: JSONL rows {"messages":
[system, user, assistant]}.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional

from ..pipeline.erc_chat import _PROMPTS

EN_SPEAKERS = {
    "Ses01": {"F": "Mary", "M": "James"},
    "Ses02": {"F": "Patricia", "M": "John"},
    "Ses03": {"F": "Jennifer", "M": "Robert"},
    "Ses04": {"F": "Linda", "M": "Michael"},
    "Ses05": {"F": "Elizabeth", "M": "William"},
}
ZH_SPEAKERS = {
    "Ses01": {"F": "张晓红", "M": "王凯"},
    "Ses02": {"F": "李丽", "M": "刘伟"},
    "Ses03": {"F": "赵敏", "M": "陈强"},
    "Ses04": {"F": "孙婷", "M": "周杰"},
    "Ses05": {"F": "吴静", "M": "郑宇"},
}
EN_LABELS = {0: "happy", 1: "sad", 2: "neutral", 3: "angry", 4: "excited", 5: "frustrated"}
ZH_LABELS = {0: "快乐", 1: "中性", 2: "悲伤", 3: "厌恶", 4: "愤怒", 5: "恐惧", 6: "惊讶"}


def label_map(language: str) -> Dict[int, str]:
    return EN_LABELS if language == "en" else ZH_LABELS


def label_set(language: str) -> List[str]:
    return list(label_map(language).values())


def speaker_name(
    conv_id: str, gender: str, language: str, explicit: Optional[str] = None
) -> str:
    if explicit is not None:
        return explicit
    table = EN_SPEAKERS if language == "en" else ZH_SPEAKERS
    name = table[conv_id[:5]][gender]
    return name.upper() if language == "en" else name


def clean_bio(text: str) -> str:
    """Strip model-control tokens/newlines from a generated speaker bio
    (reference preprocess_desc_speaker contract)."""
    text = text.split("</s>")[0].replace("<s>", "").replace("\n", " ")
    return re.sub(r" {2,}", " ", text)


def _names(conv: dict, s_id: str, language: str) -> List[str]:
    speakers = conv.get("speakers")
    return [
        speaker_name(s_id, g, language, speakers[i] if speakers else None)
        for i, g in enumerate(conv["genders"])
    ]


def context_window(sentences: List[str], names: List[str], i: int, window: int) -> str:
    lo, hi = max(0, i - window), min(len(sentences), i + window + 1)
    return "\n".join(f" {names[j]}: {sentences[j]}" for j in range(lo, hi))


def conversation_to_messages(
    s_id: str,
    conv: dict,
    window: int = 5,
    mode: str = "default",           # "default" | "spdescV2"
    language: str = "en",
    bios: Optional[List[str]] = None,  # per-utterance speaker bios (spdescV2)
) -> List[dict]:
    names = _names(conv, s_id, language)
    labels = label_map(language)
    P = _PROMPTS[language]
    out = []
    for i, sent in enumerate(conv["sentences"]):
        system = P["system"]
        if mode == "spdescV2":
            bio = clean_bio(bios[i]) if bios else ""
            system += P["bio"].format(name=names[i], bio=bio)
            q = P["question_spdesc"].format(name=names[i], sent=sent)
        else:
            q = P["question_default"].format(name=names[i], sent=sent)
        system += P["context"].format(ctx=context_window(conv["sentences"], names, i, window))
        out.append(
            {
                "messages": [
                    {"role": "system", "content": system},
                    {"role": "user", "content": q},
                    {"role": "assistant", "content": labels[conv["labels"][i]]},
                ]
            }
        )
    return out


def process_dataset(
    in_json: str,
    out_jsonl: str,
    window: int = 5,
    mode: str = "default",
    language: str = "en",
    bios_json: Optional[str] = None,
) -> int:
    """Reformat a {conv_id: conv} JSON into a chat JSONL; returns #samples.
    Output-name convention mirrors the reference
    (*.0shot_w{window}_{mode}.jsonl)."""
    with open(in_json, encoding="utf-8") as f:
        data = json.load(f)
    bios_all = None
    if bios_json:
        with open(bios_json, encoding="utf-8") as f:
            bios_all = json.load(f)
    rows = []
    for s_id, conv in data.items():
        bios = bios_all.get(s_id) if bios_all else None
        rows.extend(
            conversation_to_messages(s_id, conv, window, mode, language, bios)
        )
    Path(out_jsonl).parent.mkdir(parents=True, exist_ok=True)
    with open(out_jsonl, "w", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")
    return len(rows)


def default_output_path(in_json: str, window: int, mode: str) -> str:
    return str(in_json).replace(".json", f".0shot_w{window}_{mode}.jsonl")
