"""The port's native host library (``mmmm_tpu_torch/utils/native.py`` over
its own ``mmmm_tpu_torch/native/mmmm_native.cpp``), its ``utils/io.py``
containers and ``utils/viewer.py``, against the JAX package's
``mmmm_tpu.utils`` (``zstandard`` and its own native library) on the same
seeded inputs.

zstd interop both ways: one-shot frames at levels 1, 3 and 19, frames
written by ``zstandard``'s ``stream_writer`` (no content size), two frames
one after another; ``.pt.zst`` and ``.arr.zst`` files across the packages
both ways, byte for byte once decoded; the trilinear resize bit for bit
(the same C++ source and flags); the prefetcher.
"""
import io
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
import zstandard

from mmmm_tpu.utils import io as jio
from mmmm_tpu.utils import native as jnative
from mmmm_tpu_torch.utils import io as pio
from mmmm_tpu_torch.utils import native

ROOT = Path(__file__).resolve().parent.parent

DATA = bytes(np.random.default_rng(0).integers(0, 8, size=200_000, dtype=np.uint8)) \
    + b"medical imaging " * 4000


@pytest.fixture(scope="module", autouse=True)
def jax_native(tmp_path_factory):
    """``mmmm_tpu.utils.native`` over a private build of the JAX package's
    source with its Makefile's flags: its own ``make`` writes into
    ``native/``, which tests/test_native.py may be building at the same
    time in another worker."""
    d = tmp_path_factory.mktemp("jax_native")
    shutil.copy(ROOT / "native" / "mmmm_native.cpp", d / "mmmm_native.cpp")
    so = d / "libmmmm_native.so"
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-Wall", "-shared", "-fPIC",
                    "-o", str(so), str(d / "mmmm_native.cpp"), "-lzstd", "-lpthread"],
                   check=True, capture_output=True)
    os.utime(d / "mmmm_native.cpp", (0, 0))  # older than the library: no rebuild
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "_NATIVE_DIR", d)
    mp.setattr(jnative, "_LIB_PATH", so)
    mp.setattr(jnative, "_lib", None)
    yield
    mp.undo()


def _stream_frame(data: bytes, level: int = 3) -> bytes:
    buf = io.BytesIO()
    with zstandard.ZstdCompressor(level=level).stream_writer(buf, closefd=False) as w:
        w.write(data[: len(data) // 3])
        w.write(data[len(data) // 3:])
    return buf.getvalue()


@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_frames_read_both_ways(level):
    ours = native.zstd_compress(DATA, level)
    assert zstandard.ZstdDecompressor().decompress(ours) == DATA
    assert jnative.zstd_decompress(ours) == DATA
    assert native.zstd_decompress(zstandard.ZstdCompressor(level=level).compress(DATA)) == DATA
    assert native.zstd_decompress(jnative.zstd_compress(DATA, level)) == DATA
    unsized = native.zstd_compress(DATA, level, content_size=False)
    assert zstandard.get_frame_parameters(unsized).content_size in (-1, 2 ** 64 - 1)
    assert zstandard.ZstdDecompressor().stream_reader(io.BytesIO(unsized)).read() == DATA
    assert native.zstd_decompress(unsized) == DATA


def test_frames_without_content_size_and_concatenated():
    """What the JAX package's stream reader reads: a ``stream_writer`` frame
    (no content size; its own native decoder refuses it), two frames one
    after another (with and without sizes), and a skippable frame."""
    frame = _stream_frame(DATA)
    assert zstandard.get_frame_parameters(frame).content_size in (-1, 2 ** 64 - 1)
    with pytest.raises(ValueError, match="invalid zstd frame"):
        jnative.zstd_decompress(frame)
    second = b"second frame " * 100
    two = zstandard.ZstdCompressor().compress(second) + frame
    skippable = b"\x50\x2a\x4d\x18" + (4).to_bytes(4, "little") + b"skip"
    for data, want in ((frame, DATA), (two, second + DATA),
                       (native.zstd_compress(DATA) + skippable + frame, DATA + DATA)):
        ref = zstandard.ZstdDecompressor().stream_reader(io.BytesIO(data)).read()
        assert ref == want
        assert native.zstd_decompress(data) == want
    assert native.zstd_decompress(b"") == b""
    for bad in (frame[:-7], b"not zstd", native.zstd_compress(DATA)[:100]):
        with pytest.raises(ValueError, match="invalid or truncated"):
            native.zstd_decompress(bad)


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"image": rng.integers(0, 255, (1, 4, 16, 16), dtype=np.uint8),
            "meta": {"spacing": rng.normal(size=3).astype(np.float32), "n": 3,
                     "masks": [rng.random((2, 4, 4)) > 0.5, np.arange(5, dtype=np.int64)]}}


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    else:
        assert a == b


def test_pt_zst_across_packages(tmp_path):
    """Each package reads the other's ``.pt.zst`` (and a ``stream_writer``
    file, which the reference's processed datasets may hold); the bytes the
    port reads back are the ones the JAX reader reads."""
    tree = _tree(1)
    pio.save_pt_zst(tree, tmp_path / "port.pt.zst")
    jio.save_pt_zst(tree, tmp_path / "jax.pt.zst")
    buf = io.BytesIO()
    torch.save({"image": torch.from_numpy(tree["image"])}, buf)
    (tmp_path / "stream.pt.zst").write_bytes(_stream_frame(buf.getvalue()))
    for name in ("port", "jax"):
        _assert_tree_equal(jio.load_pt_zst(tmp_path / f"{name}.pt.zst"), tree)
        _assert_tree_equal(pio.load_pt_zst(tmp_path / f"{name}.pt.zst"), tree)
    _assert_tree_equal(pio.load_pt_zst(tmp_path / "stream.pt.zst"),
                       jio.load_pt_zst(tmp_path / "stream.pt.zst"))
    for name in ("port", "jax", "stream"):
        raw = (tmp_path / f"{name}.pt.zst").read_bytes()
        ref = zstandard.ZstdDecompressor().stream_reader(io.BytesIO(raw)).read()
        assert native.zstd_decompress(raw) == ref


@pytest.mark.parametrize("dtype", ["uint8", "float32", "int64", "bool"])
def test_arr_zst_across_packages(tmp_path, dtype):
    arr = (np.random.default_rng(2).normal(size=(3, 5, 7)) * 40).astype(dtype)
    pio.save_array_zst(arr, tmp_path / "port.arr.zst", level=19)
    jio.save_array_zst(arr, tmp_path / "jax.arr.zst")
    for name in ("port", "jax"):
        for load in (jio.load_array_zst, pio.load_array_zst):
            got = load(tmp_path / f"{name}.arr.zst")
            assert got.dtype == arr.dtype and np.array_equal(got, arr)
    raw = (tmp_path / "jax.arr.zst").read_bytes()
    (tmp_path / "stream.arr.zst").write_bytes(
        raw[:12 + int.from_bytes(raw[8:12], "little")] + _stream_frame(arr.tobytes()))
    assert np.array_equal(pio.load_array_zst(tmp_path / "stream.arr.zst"), arr)
    (tmp_path / "bad.arr.zst").write_bytes(b"NOTMAGIC")
    with pytest.raises(ValueError, match="not an .arr.zst"):
        pio.load_array_zst(tmp_path / "bad.arr.zst")


@pytest.mark.parametrize("shape_in,shape_out", [((2, 4, 10, 12), (6, 20, 24)),
                                                ((2, 6, 20, 24), (4, 13, 11)),
                                                ((1, 5, 9, 9), (5, 9, 9))])
def test_resize_bit_equal_to_jax_native(shape_in, shape_out):
    """The same C++ source and flags: bit for bit the JAX package's native
    resize, and within 2e-3 of torch's trilinear (tests/test_native.py's
    bound)."""
    vol = np.random.default_rng(3).integers(0, 255, size=shape_in, dtype=np.uint8)
    got = native.resize_trilinear_u8(vol, shape_out)
    assert got.dtype == np.float32 and got.shape == (shape_in[0], *shape_out)
    assert np.array_equal(got.view(np.uint32),
                          jnative.resize_trilinear_u8(vol, shape_out).view(np.uint32))
    want = torch.nn.functional.interpolate(
        torch.from_numpy(vol.astype(np.float32) / 255.0)[None], size=shape_out,
        mode="trilinear", align_corners=False)[0].numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)
    with pytest.raises(ValueError, match="positive sizes"):
        native.resize_trilinear_u8(vol, (0, 4, 4))


def test_prefetcher(tmp_path):
    """zstd files (one-shot, stream-written, concatenated) come back decoded
    in any order of waits, a plain file raw, a missing one raises."""
    rng = np.random.default_rng(4)
    contents = [bytes(rng.integers(0, 255, size=10_000 + i, dtype=np.uint8)) for i in range(6)]
    frames = [native.zstd_compress(contents[0]), _stream_frame(contents[1]),
              native.zstd_compress(contents[2]) + _stream_frame(contents[3])]
    expect = [contents[0], contents[1], contents[2] + contents[3]]
    for i in range(4, 6):
        frames.append(zstandard.ZstdCompressor(level=i).compress(contents[i]))
        expect.append(contents[i])
    paths = []
    for i, fr in enumerate(frames):
        paths.append(tmp_path / f"f{i}.zst")
        paths[-1].write_bytes(fr)
    (tmp_path / "raw.bin").write_bytes(b"hello raw")
    with native.NativePrefetcher(n_threads=3) as pf:
        jobs = [pf.submit(p) for p in paths]
        raw_job = pf.submit(tmp_path / "raw.bin")
        for job, want in reversed(list(zip(jobs, expect))):
            assert pf.wait(job) == want
        assert pf.wait(raw_job) == b"hello raw"
        with pytest.raises(IOError):
            pf.wait(pf.submit(tmp_path / "missing.zst"))
    assert pf.handle is None


def test_build_from_the_ports_source_or_raise(monkeypatch, tmp_path):
    """The port builds its own copy of the source, which declares the zstd
    functions it calls (no ``zstd.h``: the card's machine has the runtime
    library alone) and links it by soname. A failed build raises with the
    command and the compiler's output; a missing compiler raises too.
    Neither leaves a library behind."""
    text = native.SOURCE.read_text()
    assert native.SOURCE.parent.parent.name == "mmmm_tpu_torch"
    assert "#include <zstd.h>" not in text and "ZSTD_decompressStream" in text
    assert "-l:libzstd.so.1" in native.LINK_FLAGS
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="native library build failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="no C.. compiler"):
        native.build()


def test_slice_viewer_scrolls(monkeypatch):
    """``SliceViewer`` under matplotlib's Agg backend: the middle slice first,
    the scroll wheel moves and clamps, the mask overlay follows."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    from mmmm_tpu_torch.utils.viewer import SliceViewer

    vol = np.random.default_rng(5).random((5, 8, 8)).astype(np.float32)
    mask = vol > 0.5
    v = SliceViewer(vol, mask, alpha=0.3)
    assert v.index == 2 and v.ax.get_title() == "slice 2/4"

    class Event:
        def __init__(self, button):
            self.button = button

    for _ in range(4):
        v.on_scroll(Event("up"))
    assert v.index == 4 and np.array_equal(v.im.get_array(), vol[4])
    rgba = v.overlay.get_array()
    assert np.array_equal(rgba[..., 3] > 0, mask[4]) and np.allclose(rgba[mask[4], 3], 0.3)
    v.on_scroll(Event("down"))
    assert v.index == 3 and v.ax.get_title() == "slice 3/4"
    matplotlib.pyplot.close(v.fig)
