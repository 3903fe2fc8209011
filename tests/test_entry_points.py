"""What users and the chip run start from: the CLI, the compile-cache
helper, and chip_smoke.py's refusal to run without a GPU."""
import pathlib

import jax
import numpy as np
import pytest

from icspcodec import compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_chip_smoke_refuses_to_run_without_a_gpu():
    import chip_smoke

    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert e.value.code not in (0, None)


@pytest.fixture
def config_updates(monkeypatch):
    """Records jax.config.update calls instead of applying them."""
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda name, value: calls.append((name, value)))
    return calls


def test_compile_cache_honours_the_environment(monkeypatch, config_updates):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert config_updates == []


def test_compile_cache_defaults_to_the_checkout(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == str(REPO / ".jax_cache")
    assert config_updates == [("jax_compilation_cache_dir", path)]


@pytest.mark.parametrize("precision", ["fast", "exact"])
def test_cli_encode_decode_roundtrip(tmp_path, capsys, monkeypatch, config_updates,
                                    precision):
    """cli.main encodes a seeded YUV file and decodes it back; the planes
    equal codec.decode() of the same bytes.  (The x64 flag the CLI sets
    for exact mode is already on in the test process.)"""
    from icspcodec.cli import main
    from icspcodec.codec import decode
    from icspcodec.io import load_yuv420, save_yuv420

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    r = np.random.default_rng(5)
    h, w, nf = 64, 96, 4
    y = np.stack([np.roll(r.integers(0, 256, (h, w)).astype(np.uint8), i, 1)
                  for i in range(nf)])
    cb = r.integers(0, 256, (nf, h // 2, w // 2)).astype(np.uint8)
    cr = r.integers(0, 256, (nf, h // 2, w // 2)).astype(np.uint8)
    src, out_bin, out_yuv = tmp_path / "seq_x.yuv", tmp_path / "o.bin", tmp_path / "o.yuv"
    save_yuv420(src, y, cb, cr)
    main(["encode", "-i", str(src), "-n", str(nf), "-q", "16", "--intraPeriod", "2",
          "--width", str(w), "--height", str(h), "--precision", precision,
          "-o", str(out_bin)])
    main(["decode", "-i", str(out_bin), "-n", str(nf), "--precision", precision,
          "--orig", str(src), "-o", str(out_yuv)])
    assert "mean Y-PSNR" in capsys.readouterr().out
    assert ("jax_compilation_cache_dir", str(REPO / ".jax_cache")) in config_updates
    want = decode(out_bin.read_bytes(), nf, precision=precision)
    got = load_yuv420(str(out_yuv), w, h, nf)
    for k, plane in zip(("y", "cb", "cr"), got):
        assert np.array_equal(plane, want[k]), k
