"""Readers and writers for the reference's JSON / JSONL file contracts.

Counterpart of the JAX ``utils/manifest.py``:

- the retrieval hand-off JSONL: {zh_text, speaker, retrieved_file_id,
  retrieved_text, distance[, whisper][, retrieved_index]} (``RetrievalRow``,
  ``JsonDataReader``), written by ``cli/search_json.py`` and read by
  ``cli/tts_with_rag.py``;
- style-sample manifests: a list (or dict) of {speaker, zh_text, file_id}
  (``StyleSample``, ``load_style_manifests``, ``group_by_speaker``);
- similarity-eval rows 'name|style_text|timbre_path|text' (``meta_lst_row``,
  ``write_meta_lst``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, List, Union

PathLike = Union[str, Path]


def read_json(path: PathLike) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def write_json(path: PathLike, obj: Any) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, ensure_ascii=False, indent=2)


def read_jsonl(path: PathLike) -> List[dict]:
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in (ln.strip() for ln in f) if line]


def write_jsonl(path: PathLike, rows: Iterable[dict]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")


@dataclass
class RetrievalRow:
    """One line of the retrieval hand-off JSONL."""

    zh_text: str
    speaker: str
    retrieved_file_id: str
    retrieved_text: str
    distance: float
    whisper: bool = False
    retrieved_index: int = -1   # the DB row (serves its precomputed prompt artifacts)

    @classmethod
    def from_dict(cls, d: dict) -> "RetrievalRow":
        return cls(
            zh_text=d.get("zh_text", d.get("text", "")),
            speaker=str(d.get("speaker", "")),
            retrieved_file_id=d.get("retrieved_file_id", ""),
            retrieved_text=d.get("retrieved_text", ""),
            distance=float(d.get("distance", 0.0)),
            whisper=bool(d.get("whisper", False)),
            retrieved_index=int(d.get("retrieved_index", -1)),
        )

    def to_dict(self) -> dict:
        d = {"zh_text": self.zh_text, "speaker": self.speaker,
             "retrieved_file_id": self.retrieved_file_id,
             "retrieved_text": self.retrieved_text, "distance": self.distance}
        if self.whisper:
            d["whisper"] = True
        if self.retrieved_index >= 0:
            d["retrieved_index"] = self.retrieved_index
        return d


class JsonDataReader:
    """Indexable view over the retrieval JSONL."""

    def __init__(self, path: PathLike):
        self.rows = [RetrievalRow.from_dict(d) for d in read_jsonl(path)]

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int) -> RetrievalRow:
        if not 0 <= i < len(self.rows):
            raise IndexError(i)
        return self.rows[i]

    def __iter__(self) -> Iterator[RetrievalRow]:
        return iter(self.rows)


@dataclass
class StyleSample:
    """One style-DB entry of an insert manifest."""

    speaker: str
    zh_text: str
    file_id: str
    extras: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "StyleSample":
        known = {"speaker", "zh_text", "file_id"}
        return cls(speaker=str(d.get("speaker", "")), zh_text=d.get("zh_text", d.get("text", "")),
                   file_id=str(d.get("file_id", "")),
                   extras={k: v for k, v in d.items() if k not in known})


def load_style_manifests(paths: List[PathLike]) -> List[StyleSample]:
    samples: List[StyleSample] = []
    for p in paths:
        data = read_json(p)
        if isinstance(data, dict):
            data = list(data.values())
        samples.extend(StyleSample.from_dict(d) for d in data)
    return samples


def group_by_speaker(samples: List[StyleSample]) -> Dict[str, List[StyleSample]]:
    """Samples by speaker, speakers in order of first appearance."""
    out: Dict[str, List[StyleSample]] = {}
    for s in samples:
        out.setdefault(s.speaker, []).append(s)
    return out


def meta_lst_row(name: str, style_text: str, timbre_path: str, text: str) -> str:
    """'a|b|c|d' similarity-eval row."""
    return f"{name}|{style_text}|{timbre_path}|{text}"


def write_meta_lst(path: PathLike, rows: List[str]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + ("\n" if rows else ""))
