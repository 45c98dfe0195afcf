"""Port parity: text frontend ids and the style store's snapshot format."""

import numpy as np
import pytest

from autostyle_tts_tpu.models import frontend as jfrontend
from autostyle_tts_tpu.retrieval import StyleStore as JStyleStore
from autostyle_tts_tpu_torch.models import frontend as tfrontend
from autostyle_tts_tpu_torch.retrieval.store import StyleStore

TEXTS = [
    ("The quick brown fox jumps over the lazy dog.", "en"),
    ("今天天气很好，我们去公园散步吧。", "zh"),
    ("On 3/14/2024 at 10:30, Dr. Smith paid $1,234.56 for 42 items (17%).", None),
]


@pytest.mark.parametrize("text,lang", TEXTS)
@pytest.mark.parametrize("numbers", [True, False])
def test_frontend_ids_identical(text, lang, numbers):
    j = jfrontend.encode(text, lang, numbers=numbers)
    t = tfrontend.encode(text, lang, numbers=numbers)
    assert list(t) == list(j)
    jb = jfrontend.encode_batch([text, "hi"], [lang, None], width=128, numbers=numbers)
    tb = tfrontend.encode_batch([text, "hi"], [lang, None], width=128, numbers=numbers)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a, b)


def test_store_saved_by_jax_loads_in_port(tmp_path):
    rng = np.random.default_rng(0)
    dim, n = 48, 9
    js = JStyleStore(dim=dim, capacity=16)
    js.insert(rng.standard_normal((n, dim)).astype(np.float32),
              [{"file_id": f"f{i}", "text": f"line {i}", "speaker": "ab"[i % 2]}
               for i in range(n)])
    js.artifacts = {
        "speech_tokens": rng.integers(0, 60, (n, 12)).astype(np.int32),
        "speech_token_lens": rng.integers(4, 12, n).astype(np.int64),
        "prompt_mel": rng.standard_normal((n, 24, 16)).astype(np.float32),
        "prompt_mel_lens": rng.integers(8, 24, n).astype(np.int64),
        "spk": rng.standard_normal((n, 16)).astype(np.float32),
    }
    js.save(tmp_path / "db")
    ts = StyleStore.load(tmp_path / "db", device="cpu")
    assert len(ts) == n and ts.meta == js.meta and ts.capacity == js.capacity
    assert set(ts.artifacts) == set(js.artifacts)
    for k, v in js.artifacts.items():
        np.testing.assert_array_equal(ts.artifacts[k], v)
    q = rng.standard_normal((5, dim)).astype(np.float32)
    js_scores, js_idx = js.search_arrays(q, k=4)
    ts_scores, ts_idx = ts.search_arrays(q, k=4)
    np.testing.assert_array_equal(ts_idx, js_idx)
    np.testing.assert_allclose(ts_scores, js_scores, atol=1e-6)
    jh = js.search(q[:2], k=3, speaker="a")
    th = ts.search(q[:2], k=3, speaker="a")
    assert [[h.index for h in r] for r in th] == [[h.index for h in r] for r in jh]


def test_store_roundtrip_and_growth_in_port(tmp_path):
    rng = np.random.default_rng(1)
    s = StyleStore(dim=8, capacity=2, device="cpu")
    s.insert(rng.standard_normal((5, 8)), [{"file_id": str(i)} for i in range(5)])
    assert s.capacity >= 5
    s.artifacts = {"spk": np.arange(10, dtype=np.float32).reshape(5, 2)}
    s.save(tmp_path / "s")
    back = JStyleStore.load(tmp_path / "s")   # and the JAX package reads the port's
    np.testing.assert_array_equal(back.artifacts["spk"], s.artifacts["spk"])
    _, idx = back.search_arrays(rng.standard_normal((3, 8)).astype(np.float32), k=2)
    _, idx2 = s.search_arrays(np.asarray(back.db[:3]), k=1)
    np.testing.assert_array_equal(idx2[:, 0], np.arange(3))
    with pytest.raises(ValueError, match="dim mismatch"):
        s.insert(np.zeros((1, 3)), [{}])
