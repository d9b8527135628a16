"""The port's greedy graph-growing partitioner (``crp_tpu_torch/native/
ggp.cpp`` and its numpy twin in ``sparse/reorder.py``) against the JAX
package's, on the cases of ``tests/fixtures/ggp_oracle.json``.

The two JAX implementations decide differently from each other (a stable
numpy sort against ``std::sort``, Python's heap against
``std::priority_queue``), so the port's C++ is held to JAX's C++ and the
port's twin to JAX's twin, each bit for bit and to the fixture's digests,
part sizes and cut counts.
"""

import hashlib
import json
import os

import numpy as np
import pytest

from crp_tpu import native as jnative
from crp_tpu.sparse.reorder import _ggp_partition_py as j_twin
from tests.test_ggp_oracle import _cut_edges, _digest, _matrix

from crp_tpu_torch import native as tnative
from crp_tpu_torch.sparse import reorder as treorder

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "ggp_oracle.json")
with open(FIXTURE) as f:
    CASES = json.load(f)
IDS = [f"{c['spec']}-p{c['nparts']}" for c in CASES]


@pytest.fixture(scope="module")
def matrices():
    return {c["spec"]: _matrix(c["spec"]) for c in CASES}


def test_native_builds_here():
    """With ``g++`` present (as the JAX package's tests also require), the
    port's partitioner builds from its source into the build directory,
    keyed by the source and the flags."""
    assert tnative.available()
    so = tnative.library_path()
    assert so.exists() and so.parent == tnative.BUILD_DIR
    assert so.name.startswith("libcrp_ggp_") and so.suffix == ".so"
    assert treorder.bisect_backend() == "native"


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_native_equals_jax_native(case, matrices):
    a = matrices[case["spec"]]
    nparts, imb = case["nparts"], case["imbalance"]
    got = tnative.ggp_partition(a.rowptr, a.colidx, nparts, imb)
    want = jnative.ggp_partition(a.rowptr, a.colidx, nparts, imb)
    assert got.dtype == np.int32 and want is not None
    np.testing.assert_array_equal(got, want)
    exp = case["native"]
    assert tnative.part_digest(got) == _digest(got) == exp["sha256"]
    assert np.bincount(got, minlength=nparts).tolist() == exp["part_sizes"]
    assert _cut_edges(a, got) == exp["cut_edges"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_twin_equals_jax_twin(case, matrices):
    a = matrices[case["spec"]]
    nparts, imb = case["nparts"], case["imbalance"]
    got = treorder._ggp_partition_py(a.rowptr, a.colidx, nparts, imb)
    want = j_twin(a.rowptr, a.colidx, nparts, imb)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    exp = case["python"]
    assert tnative.part_digest(got) == _digest(got) == exp["sha256"]
    assert np.bincount(got, minlength=nparts).tolist() == exp["part_sizes"]
    assert _cut_edges(a, got) == exp["cut_edges"]


@pytest.mark.parametrize("nparts", [0, 1])
def test_trivial_part_counts(nparts, matrices):
    """One part or none: every row in part 0, as in JAX's two versions."""
    a = matrices[CASES[0]["spec"]]
    for fn in (tnative.ggp_partition, treorder._ggp_partition_py):
        part = fn(a.rowptr, a.colidx, nparts, 1.05)
        assert part.shape == (a.nrow,) and not part.any()


def test_empty_graph():
    rowptr, colidx = np.zeros(1, np.int64), np.zeros(0, np.int32)
    assert tnative.ggp_partition(rowptr, colidx, 4, 1.05).shape == (0,)
    assert treorder._ggp_partition_py(rowptr, colidx, 4, 1.05).shape == (0,)


def test_build_key_follows_source_and_flags(monkeypatch):
    """The cached library's name changes with the flags (and the source),
    so a stale build is never loaded."""
    before = tnative.library_path()
    monkeypatch.setattr(tnative, "CXX_FLAGS", tnative.CXX_FLAGS + ("-DCRP_KEY_TEST",))
    assert tnative.library_path() != before
    h = hashlib.sha256(" ".join(tnative.CXX_FLAGS).encode())
    h.update(tnative.SOURCE.read_bytes())
    assert h.hexdigest()[:16] in tnative.library_path().name


def test_a_failing_build_leaves_the_numpy_twin(monkeypatch, tmp_path):
    """Where ``g++`` fails, nothing is loaded or left behind, the native
    call returns None (JAX's contract) and the chain takes the twin."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative, "CXX_FLAGS", tnative.CXX_FLAGS + ("--no-such-flag",))
    tnative._load.cache_clear()
    try:
        assert not tnative.available()
        a = _matrix(CASES[0]["spec"])
        assert tnative.ggp_partition(a.rowptr, a.colidx, 4) is None
        assert treorder.bisect_backend() == treorder.partition_backend() == "numpy"
        assert list(tmp_path.iterdir()) == []
    finally:
        tnative._load.cache_clear()
