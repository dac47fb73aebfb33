"""On-disk format interop: byte-level roundtrips + committed-file reads."""

import gzip
import os
import struct

import numpy as np
import pytest

from cuda_selection_criteria.utils import formats
from conftest import REFERENCE, reference_available

RNG = np.random.default_rng(3)


def test_hll_roundtrip(tmp_path):
    p = 10
    core = RNG.integers(0, 52, size=1 << p, dtype=np.uint8)
    path = str(tmp_path / "x.hll")
    formats.write_hll(path, p, core)
    p2, core2, hdr = formats.read_hll(path)
    assert p2 == p
    np.testing.assert_array_equal(core, core2)
    assert hdr["estim"] == formats.ESTIM_ERTL_MLE


def test_hll_write_byte_layout(tmp_path):
    """Header layout must match hll_t::write (hll.h:1103-1111)."""
    p = 4
    core = np.arange(16, dtype=np.uint8)
    path = str(tmp_path / "y.hll")
    formats.write_hll(path, p, core)
    raw = gzip.open(path, "rb").read()
    assert struct.unpack("<4I", raw[:16]) == (0, 2, 2, 1)
    assert struct.unpack("<I", raw[16:20])[0] == p
    assert struct.unpack("<d", raw[20:28])[0] == -1.0
    assert raw[28:] == core.tobytes()


def test_smh_roundtrip(tmp_path):
    h = RNG.integers(0, 1 << 63, size=32, dtype=np.uint64)
    path = str(tmp_path / "x.smh32")
    formats.write_smh(path, h)
    h2 = formats.read_smh(path)
    np.testing.assert_array_equal(h, h2)


def test_smh_write_byte_layout(tmp_path):
    h = np.array([7, 8, 9, 10], dtype=np.uint64)
    path = str(tmp_path / "y.smh4")
    formats.write_smh(path, h)
    raw = gzip.open(path, "rb").read()
    assert struct.unpack("<I", raw[:4])[0] == 4
    assert raw[4:] == h.tobytes()


def test_bank_npz_roundtrip(tmp_path):
    regs = RNG.integers(0, 52, size=(3, 256), dtype=np.uint8)
    aux = RNG.integers(0, 1 << 63, size=(3, 8), dtype=np.uint64)
    path = str(tmp_path / "bank.npz")
    formats.save_bank(path, ["a", "b", "c"], regs, cards=np.ones(3), aux=aux,
                      aux_kind="smh")
    loaded = formats.load_bank(path)
    np.testing.assert_array_equal(loaded["regs"], regs)
    np.testing.assert_array_equal(loaded["aux"], aux)
    assert list(loaded["names"]) == ["a", "b", "c"]


@pytest.mark.skipif(not reference_available(), reason="reference not mounted")
def test_read_committed_files():
    files = [
        line.strip()
        for line in open(os.path.join(REFERENCE, "test_influeza_filelist.txt"))
        if line.strip()
    ]
    path = os.path.join(REFERENCE, files[0])
    p, core, hdr = formats.read_hll(path + ".hll")
    assert p == 14 and core.size == 1 << 14
    assert hdr["estim"] == formats.ESTIM_ERTL_MLE
    p8, core8, _ = formats.read_hll(path + ".hll_8")
    assert p8 == 8 and core8.size == 256
    h = formats.read_smh(path + ".smh64")
    assert h.size == 64


@pytest.mark.skipif(not reference_available(), reason="reference not mounted")
def test_rewrite_committed_file_identical_raw_bytes(tmp_path):
    """write(read(x)) must reproduce the committed reference files
    RAW-byte-for-byte - gzip header (bare 10-byte zlib-gzopen header:
    MTIME=0, no FNAME, XFL=0, OS=3) and level-6 deflate stream included,
    not just the decompressed payload (formats._gz_write)."""
    files = [
        line.strip()
        for line in open(os.path.join(REFERENCE, "test_influeza_filelist.txt"))
        if line.strip()
    ]
    for rel in files:
        src = os.path.join(REFERENCE, rel) + ".hll"
        p, core, hdr = formats.read_hll(src)
        dst = str(tmp_path / "re.hll")
        formats.write_hll(dst, p, core, value=hdr["value"],
                          is_calculated=hdr["is_calculated"])
        assert open(src, "rb").read() == open(dst, "rb").read(), src
        for ext in (".smh4", ".smh64"):
            s_src = os.path.join(REFERENCE, rel) + ext
            if not os.path.exists(s_src):
                continue
            s_dst = str(tmp_path / ("re" + ext))
            formats.write_smh(s_dst, formats.read_smh(s_src))
            assert open(s_src, "rb").read() == open(s_dst, "rb").read(), s_src


def test_bank_save_load_roundtrip(tmp_path):
    """Consolidated bank checkpoint: single-file and sharded roundtrips."""
    import numpy as np
    from cuda_selection_criteria.models.bank import SketchBank

    rng = np.random.default_rng(4)
    n = 10
    bank = SketchBank(
        names=[f"g{i}" for i in range(n)],
        regs=rng.integers(0, 20, size=(n, 1 << 8), dtype=np.uint8),
        p=8,
        aux_kind="smh",
        aux=rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64),
        aux_param=4,
    )
    single = str(tmp_path / "bank.npz")
    bank.save(single)
    got = SketchBank.load(single)
    assert got.names == bank.names and got.p == 8
    np.testing.assert_array_equal(got.regs, bank.regs)
    np.testing.assert_array_equal(got.aux, bank.aux)
    np.testing.assert_array_equal(got.cards, bank.cards)
    assert got.aux_kind == "smh" and got.aux_param == 4

    sharded = str(tmp_path / "bank_sharded.npz")
    bank.save(sharded, shards=3)
    got3 = SketchBank.load(sharded)
    assert got3.names == bank.names
    np.testing.assert_array_equal(got3.regs, bank.regs)
    np.testing.assert_array_equal(got3.aux, bank.aux)

    # save(p)/load(p) agree when p lacks the .npz suffix (np.savez appends it)
    bare = str(tmp_path / "bank_bare")
    bank.save(bare)
    got_bare = SketchBank.load(bare)
    np.testing.assert_array_equal(got_bare.regs, bank.regs)


def test_bank_load_rejects_stale_shard_sets(tmp_path):
    """Mixed shard counts / incomplete shard sets at one base path must
    error instead of silently reassembling a corrupted bank."""
    import numpy as np
    import pytest
    from cuda_selection_criteria.models.bank import SketchBank

    rng = np.random.default_rng(5)
    n = 9
    bank = SketchBank(
        names=[f"g{i}" for i in range(n)],
        regs=rng.integers(0, 20, size=(n, 1 << 8), dtype=np.uint8),
        p=8,
    )
    base = str(tmp_path / "bank.npz")
    bank.save(base, shards=2)
    bank.save(base, shards=3)  # stale 2-shard files remain alongside
    with pytest.raises(ValueError, match="inconsistent shard set"):
        SketchBank.load(base)

    # Incomplete set: drop one shard of a clean save.
    base2 = str(tmp_path / "bank2.npz")
    bank.save(base2, shards=3)
    os.remove(base2 + ".shard0001-of-0003.npz")
    with pytest.raises(ValueError, match="incomplete shard set"):
        SketchBank.load(base2)


def test_native_batch_loaders_match_python():
    """Threaded C++ batch loaders return identical bytes to the Python
    readers on the committed reference sketches."""
    import pytest
    from cuda_selection_criteria.native import fastx as native
    from cuda_selection_criteria.utils import formats
    from tests.conftest import reference_available

    if not native.available():
        pytest.skip("libfastx.so unavailable")
    if not reference_available():
        pytest.skip("reference corpus unavailable")
    import glob
    import numpy as np

    base = "/root/reference/datasets/test_influenzaA"
    hll = sorted(glob.glob(base + "/*.fna.gz.hll"))
    smh = sorted(glob.glob(base + "/*.fna.gz.smh4"))
    assert hll and smh
    got = native.read_hll_batch(hll, 14, threads=4)
    want = np.stack([formats.read_hll(f)[1] for f in hll])
    np.testing.assert_array_equal(got, want)
    got_s = native.read_smh_batch(smh, 4, threads=4)
    want_s = np.stack([formats.read_smh(f) for f in smh])
    np.testing.assert_array_equal(got_s, want_s)
    # wrong p / m must error, not silently misparse
    with pytest.raises(IOError):
        native.read_hll_batch(hll, 10, threads=2)
    with pytest.raises(IOError):
        native.read_smh_batch(smh, 64, threads=2)


def test_profiling_timed_emits_row(capsys):
    import jax.numpy as jnp
    from cuda_selection_criteria.utils.profiling import timed

    with timed("region") as sink:
        sink["x"] = jnp.arange(8).sum()
    out = capsys.readouterr().out
    assert out.startswith("region;")
