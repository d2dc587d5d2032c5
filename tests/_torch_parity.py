"""Shared comparison rules of the PyTorch-port parity tests.

Tolerance (stated once, used by every test_torch_* file): rows and ranks are
exactly equal; scores match to rtol 1e-5 / atol 1e-6, the room fp32
summation order needs (the two frameworks sum dot products and BM25 terms
in different orders). The only row difference allowed is a swap of two
candidates whose reference scores differ by less than that tolerance, and
`assert_rows_match` checks exactly that. Graph adjacencies, which carry no
scores, follow `assert_edges_match`'s near-tie rule.
"""

from __future__ import annotations

import numpy as np
import torch

RTOL = 1e-5
ATOL = 1e-6
TIE_TOL = 1e-6  # graph edges: float64 cosine gap of a near-tie


def assert_rows_match(ref_rows, ref_scores, got_rows, got_scores, what=""):
    ref_rows = np.asarray(ref_rows)
    got_rows = np.asarray(got_rows)
    ref_scores = np.asarray(ref_scores, np.float64)
    got_scores = np.asarray(got_scores, np.float64)
    assert ref_rows.shape == got_rows.shape, (what, ref_rows.shape, got_rows.shape)
    for q in range(ref_rows.shape[0]):
        r, g = ref_rows[q], got_rows[q]
        for i in np.nonzero(r != g)[0]:
            j = np.nonzero(r == g[i])[0]
            assert len(j) == 1 and g[j[0]] == r[i], (
                f"{what}: query {q} slot {i}: row {g[i]} is not a swap of {r[i]}", r, g)
            gap = abs(ref_scores[q, i] - ref_scores[q, j[0]])
            assert gap <= ATOL + RTOL * abs(ref_scores[q, i]), (
                f"{what}: query {q} swaps rows {r[i]}, {g[i]} whose scores differ by {gap}")
    live = ref_rows >= 0
    np.testing.assert_allclose(got_scores[live], ref_scores[live], rtol=RTOL, atol=ATOL,
                               err_msg=what)


def assert_result_match(ref, got, what=""):
    """search_rows results: {'dense'|'bm25'|'fused': (scores, rows)}."""
    assert set(ref) == set(got)
    for leg in ref:
        assert_rows_match(ref[leg][1], ref[leg][0], got[leg][1], got[leg][0],
                          f"{what} {leg}")


def assert_edges_match(ref, got, vecs, deg, bf16=False, cascade_rows=0, what=""):
    """Two (N, deg + L) adjacencies: the KNN columns equal up to near-ties
    (where they disagree, the two neighbours' float64 cosines to the row,
    over the bf16-rounded vectors when `bf16`, differ by at most TIE_TOL;
    no -1 against an edge), at most `cascade_rows` rows excepted; the L
    long-range columns equal."""
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    np.testing.assert_array_equal(ref[:, deg:], got[:, deg:], err_msg=what)
    t = torch.from_numpy(np.asarray(vecs, np.float32))
    v = (t.bfloat16() if bf16 else t).double().numpy()
    bad = []
    for i in np.nonzero((ref[:, :deg] != got[:, :deg]).any(axis=1))[0]:
        a, b = ref[i, :deg], got[i, :deg]
        p = np.nonzero(a != b)[0]
        if (a[p] < 0).any() or (b[p] < 0).any() or \
                np.abs(v[a[p]] @ v[i] - v[b[p]] @ v[i]).max() > TIE_TOL:
            bad.append(int(i))
    assert len(bad) <= cascade_rows, (what, len(bad), bad[:5],
                                      [(ref[i, :deg], got[i, :deg]) for i in bad[:2]])
