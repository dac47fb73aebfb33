"""Multi-chip sharded selection on a virtual 8-device CPU mesh: results must
equal the single-chip tiled engine (and the golden output)."""

import os

import jax
import numpy as np
import pytest

from cuda_selection_criteria.models import SketchBank
from cuda_selection_criteria.parallel import mesh as mesh_mod
from cuda_selection_criteria.parallel.selection import (
    SelectionParams,
    select_pairs,
)
from conftest import REFERENCE, reference_available


def test_eight_virtual_devices_present():
    assert len(jax.devices()) == 8


def test_make_mesh_shapes():
    m = mesh_mod.make_mesh()
    assert m.shape["rows"] * m.shape["regs"] == 8
    m2 = mesh_mod.make_mesh(n_rows=8, n_regs=1)
    assert m2.shape["rows"] == 8


@pytest.mark.skipif(not reference_available(), reason="reference not mounted")
@pytest.mark.parametrize("mesh_shape", [(4, 2), (8, 1), (2, 4)])
def test_sharded_equals_single_chip(mesh_shape):
    files = [
        os.path.join(REFERENCE, line.strip())
        for line in open(os.path.join(REFERENCE, "test_influeza_filelist.txt"))
        if line.strip()
    ]
    bank = SketchBank.from_sketch_files(files, criterion="smh_a", aux_bytes=32)
    params = SelectionParams(tau=0.9, criterion="smh_a", aux_bytes=32)
    single = select_pairs(bank, params)
    m = mesh_mod.make_mesh(n_rows=mesh_shape[0], n_regs=mesh_shape[1])
    sharded = mesh_mod.select_pairs_sharded(bank, params, m)
    assert [(a, b) for a, b, _ in single] == [(a, b) for a, b, _ in sharded]
    np.testing.assert_array_equal(
        np.array([j for _, _, j in single]),
        np.array([j for _, _, j in sharded]),
    )


def test_multihost_tile_slices_reassemble_exactly():
    """Emulate a 3-process multihost run serially: the disjoint per-process
    shards (parallel.distributed) must reassemble to the single-host
    result in reference row order."""
    import numpy as np
    from cuda_selection_criteria.parallel import distributed
    from cuda_selection_criteria.parallel.selection import SelectionParams
    from cuda_selection_criteria.parallel.screened import select_pairs_screened
    from tests.test_screen import _make_bank

    rng = np.random.default_rng(41)
    bank = _make_bank(24, 10, 16, rng)
    params = SelectionParams(tau=0.15, criterion="smh_a")
    single = select_pairs_screened(bank, params, ti=256, chunk=4)

    shards = []
    n_proc = 3
    for pid in range(n_proc):
        orig = distributed.tile_slice

        def fake_slice(n_tiles, process_index=None, process_count=None,
                       _pid=pid):
            return orig(n_tiles, _pid, n_proc)

        distributed.tile_slice = fake_slice
        try:
            shards.append(
                distributed.select_pairs_multihost(bank, params, ti=256,
                                                   chunk=2)
            )
        finally:
            distributed.tile_slice = orig
    merged = distributed.merge_multihost_results(shards)
    assert [(a, b, round(j, 12)) for a, b, j in single] == [
        (a, b, round(j, 12)) for a, b, j in merged
    ]
    assert len(single) > 0  # the planted pool guarantees some pairs
