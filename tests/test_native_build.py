"""Native C++ single-pass sketch builder: bit-exact vs the committed
reference sketches and vs the device build pipeline."""

import os

import numpy as np
import pytest

from cuda_selection_criteria.models.bank import build_bank_from_files
from cuda_selection_criteria.native import fastx as native
from cuda_selection_criteria.utils import formats
from conftest import REFERENCE, reference_available


def _influenza_files():
    return [
        os.path.join(REFERENCE, line.strip())
        for line in open(os.path.join(REFERENCE, "test_influeza_filelist.txt"))
        if line.strip()
    ]


pytestmark = pytest.mark.skipif(
    not reference_available(), reason="reference not mounted")


@pytest.fixture(scope="module", autouse=True)
def _need_native():
    if not native.available():
        pytest.skip("libfastx.so unavailable")


def test_native_build_matches_committed_sketches():
    files = _influenza_files()
    for f in files:
        regs, regs_aux, smh, n = native.build_sketches(f, k=31, p=14,
                                                       p_aux=8, m=4)
        np.testing.assert_array_equal(regs, formats.read_hll(f + ".hll")[1])
        np.testing.assert_array_equal(
            regs_aux, formats.read_hll(f + ".hll_8")[1])
        np.testing.assert_array_equal(smh, formats.read_smh(f + ".smh4"))
        assert n > 0


@pytest.mark.parametrize("crit,aux_bytes", [("smh_a", 32), ("hll_a", 256)])
def test_native_bank_equals_device_bank(crit, aux_bytes):
    files = _influenza_files()
    nat = build_bank_from_files(files, criterion=crit, aux_bytes=aux_bytes,
                                backend="native")
    dev = build_bank_from_files(files, criterion=crit, aux_bytes=aux_bytes,
                                backend="device")
    np.testing.assert_array_equal(nat.regs, dev.regs)
    np.testing.assert_array_equal(nat.aux, dev.aux)
    np.testing.assert_array_equal(nat.cards, dev.cards)


def test_auto_backend_picks_native_for_small_corpora():
    files = _influenza_files()
    bank = build_bank_from_files(files, criterion="smh_a", aux_bytes=32,
                                 backend="auto")
    # auto picks native whenever the library is built; output equals committed
    np.testing.assert_array_equal(
        bank.regs[0], formats.read_hll(files[0] + ".hll")[1])
