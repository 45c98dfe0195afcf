"""The port's native audio loader (``utils/native_audio.py``) against its
numpy loader, mirroring ``tests/test_native_audio.py``.

The port builds ``native/asttts_audio.cpp`` with ``g++`` into
``autostyle_tts_tpu_torch/_build/`` and never touches ``native/``: the
tracked ``libasttts_audio.so`` keeps its bytes. Decoding is exact (PCM16
over 32768 in both); the resampler sums its taps in double in another
order than numpy's einsum, so it is held to 1e-6 (measured: at most
3.0e-8, one float32 ulp, on a third to a half of the samples). Without a library
(``ASTTTS_NATIVE=0``) every loader is the numpy one. ``load_wav_fast``
decodes with numpy; an IEEE-float wav, which numpy's ``wave`` reader
refuses, it decodes in C++ (the written float32 samples exactly).
"""

import hashlib
import struct
import wave

import numpy as np
import pytest

from autostyle_tts_tpu_torch.ops.resample import resample_poly_np
from autostyle_tts_tpu_torch.utils import native_audio
from autostyle_tts_tpu_torch.utils.audio_io import load_wav, read_wav, write_wav

TRACKED = native_audio.SOURCE.parent / "libasttts_audio.so"


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest() if path.exists() else None


TRACKED_DIGEST = _digest(TRACKED)    # taken before anything in this process builds


@pytest.fixture(scope="module")
def lib():
    if native_audio.get_lib() is None:
        pytest.skip("no g++ to build the native audio library")
    return native_audio.get_lib()


def _tone(sr, seconds=0.5, f=440.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    return (0.4 * np.sin(2 * np.pi * f * t) + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


def test_build_lands_in_the_port_build_dir(lib, tmp_path, monkeypatch):
    """The library is the port's own build, under ``_build/``, named by the
    source's hash; a build into an empty directory works; ``native/``'s
    tracked library keeps its bytes."""
    assert native_audio.library_path().parent == native_audio.PKG_DIR / "_build"
    assert native_audio.library_path().exists()
    monkeypatch.setattr(native_audio, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native_audio, "_lib", None)
    monkeypatch.setattr(native_audio, "_tried", False)
    assert native_audio.available()
    assert [p.name for p in tmp_path.iterdir()] == [native_audio.library_path().name]
    assert _digest(TRACKED) == TRACKED_DIGEST


def test_native_wav_decode_matches_numpy(lib, tmp_path):
    x = _tone(22050)
    p = tmp_path / "t.wav"
    write_wav(p, x, 22050)
    nx, nsr = native_audio.read_wav_native(str(p))
    px, psr = read_wav(p)
    assert nsr == psr == 22050
    np.testing.assert_array_equal(nx, px)


@pytest.mark.parametrize("sr_in,sr_out", [(22050, 16000), (16000, 24000), (24000, 16000)])
def test_native_resample_matches_numpy(lib, sr_in, sr_out):
    x = _tone(sr_in)
    ours = native_audio.resample_native(x, sr_in, sr_out)
    ref = resample_poly_np(x, sr_in, sr_out)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_native_batch_loader(lib, tmp_path):
    paths = []
    for i in range(6):
        p = tmp_path / f"w{i}.wav"
        write_wav(p, _tone(22050, seconds=0.2 + 0.1 * i, f=200 + 50 * i, seed=i), 22050)
        paths.append(str(p))
    stride = 16000
    batch, lengths, status = native_audio.load_batch_native(paths, target_sr=16000, expect_sr=22050,
                                                            stride=stride, n_threads=4)
    assert (status == 0).all() and batch.shape == (6, stride)
    for i, p in enumerate(paths):
        ref = load_wav(p, 16000)
        m = min(len(ref), stride)
        assert lengths[i] == m
        np.testing.assert_allclose(batch[i, :m], ref[:m], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(batch[i, m:], 0.0)


def test_native_batch_mixed_rates(lib, tmp_path):
    """Files at the target rate are copied verbatim; other rates fail for
    their row only."""
    w16, w8 = tmp_path / "w16.wav", tmp_path / "w8.wav"
    write_wav(w16, _tone(16000), 16000)
    write_wav(w8, _tone(8000), 8000)
    batch, lengths, status = native_audio.load_batch_native([str(w16), str(w8)], target_sr=16000,
                                                            expect_sr=22050, stride=8000)
    assert status[0] == 0 and lengths[0] == 8000
    np.testing.assert_array_equal(batch[0], read_wav(w16)[0])
    assert status[1] != 0 and lengths[1] == 0


def test_load_wav_fast_native_and_fallback(lib, tmp_path, monkeypatch):
    """``load_wav_fast`` through the library, and with ``ASTTTS_NATIVE=0``
    through the numpy loader: the same samples; a missing file raises."""
    p = tmp_path / "t.wav"
    write_wav(p, _tone(22050), 22050)
    ref = load_wav(p, 16000)
    np.testing.assert_allclose(native_audio.load_wav_fast(str(p), 16000), ref, rtol=0, atol=1e-6)
    monkeypatch.setenv("ASTTTS_NATIVE", "0")
    monkeypatch.setattr(native_audio, "_lib", None)
    monkeypatch.setattr(native_audio, "_tried", False)
    assert not native_audio.available()
    np.testing.assert_array_equal(native_audio.load_wav_fast(str(p), 16000), ref)
    with pytest.raises(RuntimeError, match="unavailable"):
        native_audio.read_wav_native(str(p))
    with pytest.raises(FileNotFoundError):
        native_audio.load_wav_fast(str(tmp_path / "missing.wav"), 16000)


def _write_float_wav(path, x, sr):
    """A mono IEEE-float (format 3) wav, which the ``wave`` module does not read."""
    data = np.asarray(x, "<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, sr, sr * 4, 4, 32)
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data)) + b"WAVE"
                     + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(data)) + data)


def test_load_wav_fast_float_wav(lib, tmp_path, monkeypatch):
    """An IEEE-float wav: the numpy loader refuses it, ``load_wav_fast``
    decodes it in C++ (the samples as written) and resamples it as the
    numpy resampler does; without the library it raises as numpy's does."""
    p = tmp_path / "f.wav"
    x = _tone(22050)
    _write_float_wav(p, x, 22050)
    with pytest.raises(wave.Error):
        load_wav(p, 16000)
    np.testing.assert_array_equal(native_audio.load_wav_fast(str(p), 22050), x)
    np.testing.assert_allclose(native_audio.load_wav_fast(str(p), 16000), resample_poly_np(x, 22050, 16000),
                               rtol=0, atol=1e-6)
    monkeypatch.setenv("ASTTTS_NATIVE", "0")
    monkeypatch.setattr(native_audio, "_lib", None)
    monkeypatch.setattr(native_audio, "_tried", False)
    with pytest.raises(wave.Error):
        native_audio.load_wav_fast(str(p), 16000)
