"""The ERC fine-tune's chat format, as the RAG embedder serves it.

The port's own copy of what the JAX ``EmbedderService`` imports from the
JAX package's training code: the role tokens ``SYS, USER, ASSIST, END``,
``render_chat`` and ``decode_assistant`` (``train/lora_sft.py:49-86``) and
the system / context / question messages ``_PROMPTS``
(``train/reformat.py:80-93``). An adapter trained in this format labels
emotions through it; ``pipeline/rag.py`` renders its prompts here.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..models import frontend

SYS, USER, ASSIST, END = 10, 11, 12, 13  # role tokens (the frontend reserves 10-15)

_PROMPTS = {
    "en": {
        "system": "### You are an expert at analyzing the emotion of utterances among speakers in a conversation.",
        "bio": "\n### Given the characteristic of this speaker, {name}: \n{bio}",
        "context": "\n### Given the following conversation as a context \n{ctx}",
        "question_default": 'Based on above conversation, which emotional label of {name} in the utterance "{sent}".',
        "question_spdesc": 'Based on above conversation and characteristic of the speakers, which emotional label of {name} in the utterance "{sent}".',
    },
    "zh": {
        "system": "### 你是分析对话中说话人情感的专家。",
        "bio": "\n### 以下是说话人 {name} 的特征描述：\n{bio}",
        "context": "\n### 以下对话作为上下文：\n{ctx}",
        "question_default": "根据以上对话，{name} 在话语“{sent}”中的情感标签是什么。",
        "question_spdesc": "根据以上对话和说话人特征，{name} 在话语“{sent}”中的情感标签是什么。",
    },
}


def render_chat(messages: List[dict], add_generation_prompt: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """messages -> (ids, loss_mask). Template:
    [BOS] SYS <sys bytes> END USER <user bytes> END ASSIST <label bytes> END;
    loss_mask is 1 on the assistant's content and its END."""
    ids: List[int] = [frontend.BOS_ID]
    mask: List[int] = [0]
    role_tok = {"system": SYS, "user": USER, "assistant": ASSIST}
    for m in messages:
        body = [frontend.BYTE_OFFSET + b for b in frontend.normalize(m["content"]).encode("utf-8")]
        is_a = m["role"] == "assistant"
        ids += [role_tok[m["role"]]] + body + [END]
        mask += [0] + [1 if is_a else 0] * len(body) + [1 if is_a else 0]
    if add_generation_prompt:
        ids.append(ASSIST)
        mask.append(0)
    return np.asarray(ids, np.int32), np.asarray(mask, np.int32)


def decode_assistant(ids: Sequence[int]) -> str:
    """The first assistant span of generated ids. Ids past the byte plane
    (a large-vocabulary model can emit any id) are skipped as unknown."""
    out = []
    for i in (int(i) for i in ids):
        if i == END or i < frontend.BYTE_OFFSET and i != 0:
            if out:
                break
            continue
        if frontend.BYTE_OFFSET <= i < frontend.BYTE_OFFSET + 256:
            out.append(i - frontend.BYTE_OFFSET)
    return bytes(out).decode("utf-8", errors="replace").strip()
