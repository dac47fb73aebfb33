"""THE integration test: reproduce the reference's committed golden output
(results.txt) bit-for-bit - same pair set, same order, same 6-decimal
Jaccard strings - from the committed sketch files, for every criterion."""

import os

import pytest

from cuda_selection_criteria.models import SketchBank
from cuda_selection_criteria.parallel.selection import (
    SelectionParams,
    select_pairs,
    format_results,
)
from conftest import REFERENCE, reference_available

pytestmark = pytest.mark.skipif(
    not reference_available(), reason="reference not mounted"
)


def _files():
    return [
        line.strip()
        for line in open(os.path.join(REFERENCE, "test_influeza_filelist.txt"))
        if line.strip()
    ]


def _golden_lines():
    with open(os.path.join(REFERENCE, "results.txt")) as fh:
        return [line.rstrip("\n") for line in fh if line.strip()]


def _run(criterion, aux_bytes, **kw):
    files = [os.path.join(REFERENCE, f) for f in _files()]
    bank = SketchBank.from_sketch_files(files, criterion=criterion,
                                        aux_bytes=aux_bytes)
    params = SelectionParams(tau=0.9, criterion=criterion,
                             aux_bytes=aux_bytes, **kw)
    results = select_pairs(bank, params)
    # strip the REFERENCE prefix to compare against the committed lines
    prefix = REFERENCE + "/"
    lines = [
        line.replace(prefix, "") for line in format_results(results)
    ]
    return lines


def test_golden_smh_a_m4():
    assert _run("smh_a", aux_bytes=32) == _golden_lines()


def test_golden_smh_a_m64():
    assert _run("smh_a", aux_bytes=512) == _golden_lines()


def test_golden_hll_a():
    assert _run("hll_a", aux_bytes=256) == _golden_lines()


def test_golden_hll_an():
    assert _run("hll_an", aux_bytes=256) == _golden_lines()


def test_golden_cb_only_superset():
    """CB alone (plus exact confirm) must also yield the golden pairs: the
    aux criteria only prune, the confirm step decides."""
    assert _run("cb", aux_bytes=32) == _golden_lines()


def test_golden_baseline_superset():
    assert _run("baseline", aux_bytes=32) == _golden_lines()


def test_small_blocks_tile_boundaries():
    """Tiny tile size forces multi-tile paths incl. diagonal masks."""
    assert _run("smh_a", aux_bytes=32, block=3) == _golden_lines()


def test_int8_precision_path():
    assert _run("smh_a", aux_bytes=32, precision="int8") == _golden_lines()


def test_golden_screened_engine_p14():
    """The screened engine (forced on the CPU) must reproduce the golden
    pairs at the flagship p=14 configuration - the same engine/config the
    GPU runs."""
    assert _run("smh_a", aux_bytes=32, engine="screened") == _golden_lines()


@pytest.mark.skipif(not reference_available(), reason="reference not mounted")
@pytest.mark.parametrize("engine", ["ring", "sharded"])
def test_cli_engine_flag_golden(engine, capsys, tmp_path):
    """The selection CLI's --engine switch must route to the requested
    engine and still print the verbatim golden output."""
    from cuda_selection_criteria.cli import selection

    lst = tmp_path / "filelist.txt"
    lst.write_text("\n".join(
        os.path.join(REFERENCE, line.strip())
        for line in open(os.path.join(REFERENCE, "test_influeza_filelist.txt"))
        if line.strip()
    ) + "\n")
    # -b 128 keeps the 8-virtual-device quantum padding cheap on the CPU
    # mesh (the sharded engine pads the 1-live-tile schedule to a full
    # device quantum; 512^2-tile repeats made this test ~4 min)
    selection.main(["-l", str(lst), "-a", "32", "-h", "0.9", "-c", "smh_a",
                    "-b", "128", "--engine", engine])
    got = capsys.readouterr().out.replace(REFERENCE + "/", "")
    want = open(os.path.join(REFERENCE, "results.txt")).read()
    assert got == want


@pytest.mark.parametrize("threads", [1, 16])
def test_cli_thread_flag_preserves_golden(threads, capsys, tmp_path):
    """-t (reference: omp_set_num_threads, src/selection.cpp:113-115) is
    wired to the sketch loaders and confirm workers; any thread count must
    yield the verbatim golden output."""
    from cuda_selection_criteria.cli import selection

    lst = tmp_path / "filelist.txt"
    lst.write_text("\n".join(
        os.path.join(REFERENCE, line.strip())
        for line in open(os.path.join(REFERENCE, "test_influeza_filelist.txt"))
        if line.strip()
    ) + "\n")
    selection.main(["-l", str(lst), "-a", "32", "-h", "0.9", "-c", "smh_a",
                    "-t", str(threads)])
    got = capsys.readouterr().out.replace(REFERENCE + "/", "")
    want = open(os.path.join(REFERENCE, "results.txt")).read()
    assert got == want
