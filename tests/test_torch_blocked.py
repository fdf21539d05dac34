"""The CU-tiled fork epoch's plain version (K5's in-port reference,
``epoch_fused_blocked_ref`` / ``epoch_fused_rows_blocked_ref``) against the
reference's blocked Pallas pair, on the CPU.

The reference runs ``epoch_fused(..., block_cu=b, via_pallas=True)``: its
``_fork_blk_a`` / ``_fork_blk_b`` kernels through ``pallas_call`` in
interpret mode, as its own ``tests/test_kernels.py`` runs them. Both
packages get the same numpy-made inputs (the reference's noise included),
at the reference test's four shapes, for a counter-model reactive id, the
fork-exact reactive id and both pc ids. Tolerance as the reference holds
its blocked pair to its monolithic body: ``fidx`` and ``f_sel`` equal,
floats within 2e-4 (the blocked sums re-associate across blocks).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_parity import epoch_fields, fork_case  # noqa: E402
from _torch_rows import fork_rows_case, one_row, row_fields  # noqa: E402
from repro.kernels import epoch_fused as JKEF  # noqa: E402
from repro_torch.core import simulate as TSIM  # noqa: E402
from repro_torch.kernels import epoch_fused as KEF  # noqa: E402

TOL = 2e-4
SHAPES = [(8, 6, 4, 1), (8, 6, 2, 1), (16, 5, 4, 1), (8, 6, 4, 2)]
# a counter-model reactive id, the fork-exact reactive id, both pc ids
IDS = (0, TSIM._N_REACT - 1) + TSIM._PC_IDS


@pytest.mark.parametrize("mech", IDS)
@pytest.mark.parametrize("CU,WF,block_cu,cpd", SHAPES)
def test_blocked_plain_matches_reference_blocked_pair(CU, WF, block_cu, cpd,
                                                      mech):
    ja, jk, ta, tk = fork_case(CU, WF, 10, seed=CU + block_cu + cpd)
    jk["cus_per_domain"] = tk["cus_per_domain"] = cpd
    want = epoch_fields(JKEF.epoch_fused(*ja, **jk, mech=jnp.int32(mech),
                                         block_cu=block_cu, via_pallas=True))
    got = epoch_fields(KEF.epoch_fused_blocked_ref(
        *ta, **tk, mech=torch.tensor(mech), block_cu=block_cu))
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["fidx"], want["fidx"])
    np.testing.assert_array_equal(got["f_sel"], want["f_sel"])
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=TOL, atol=TOL,
                                   err_msg=f"id {mech} {k}")


@pytest.mark.parametrize("CU,WF,block_cu,cpd", SHAPES)
def test_blocked_plain_close_to_monolithic(CU, WF, block_cu, cpd):
    """Inside the port: the blocked plain version against the monolithic
    one at the same inputs, every traced id — the select is exact, the
    rest within the blocked tolerance."""
    _, _, ta, tk = fork_case(CU, WF, 10, seed=CU + 2 * block_cu + cpd)
    tk["cus_per_domain"] = cpd
    for mech in range(len(TSIM.FORK_MECHS)):
        m = torch.tensor(mech)
        mono = epoch_fields(KEF.epoch_fused(*ta, **tk, mech=m))
        tiled = epoch_fields(KEF.epoch_fused_blocked_ref(
            *ta, **tk, mech=m, block_cu=block_cu))
        np.testing.assert_array_equal(tiled["fidx"], mono["fidx"])
        for k, v in mono.items():
            np.testing.assert_allclose(tiled[k], v, rtol=TOL, atol=TOL,
                                       err_msg=f"id {mech} {k}")


@pytest.mark.parametrize("block_cu,tid", [(4, None), (2, [0, 2, 1, 0, 3,
                                                          1, 2, 3])])
def test_blocked_rows_equal_each_row_alone(block_cu, tid):
    """The rows variant over 7 mixed rows (every traced id, programs of
    different lengths, per-row scalars and regimes) equals each row run
    alone, bit for bit, and each row the one-row entry point."""
    args, kw = fork_rows_case(list(range(7)), 8, 10, tid=tid, seed=3,
                              objectives=("ed2p", "edp", "perfcap10"))
    rows = row_fields(KEF.epoch_fused_rows_blocked_ref(*args, **kw,
                                                       block_cu=block_cu))
    for r in range(7):
        a, k = one_row(args, kw, r)
        alone = row_fields(KEF.epoch_fused_rows_blocked_ref(
            *a, **k, block_cu=block_cu), 0)
        for name, v in alone.items():
            assert torch.equal(rows[name][r], v), (r, name)
    assert KEF.epoch_fused.launches == 0


def test_blocked_tiling_is_checked():
    args, kw = fork_rows_case([0, 5], 8, 10, cus_per_domain=2, seed=1)
    for bad in (3, 1, 0):
        with pytest.raises(ValueError, match="block_cu"):
            KEF.epoch_fused_rows_blocked_ref(*args, **kw, block_cu=bad)
    with pytest.raises(ValueError, match="lean"):
        KEF.epoch_fused_rows_blocked_ref(*args, **kw, block_cu=4,
                                         lean=False)
