"""The model artifact manager (`utils/model_manager.py`) against the JAX
package's: SHA-256, the cache, and `ensure` over `file://` URLs (nothing
reaches the network), with a good and a bad checksum."""

import hashlib

import pytest

from radiant_rag_tpu.utils import model_manager as jmm
from radiant_rag_tpu_torch.utils import model_manager as tmm

PAYLOAD = bytes(range(256)) * 9000  # > 2 MiB: several read blocks


@pytest.fixture()
def source(tmp_path):
    p = tmp_path / "src" / "lid.bin"
    p.parent.mkdir()
    p.write_bytes(PAYLOAD)
    return p


def test_sha256_file_equals_hashlib_and_jax(source):
    want = hashlib.sha256(PAYLOAD).hexdigest()
    assert tmm.sha256_file(str(source)) == jmm.sha256_file(str(source)) == want
    assert tmm.sha256_file(str(source), chunk_size=1000) == want


@pytest.mark.parametrize("mod", [tmm, jmm], ids=["port", "jax"])
def test_ensure_downloads_verifies_and_caches(tmp_path, source, mod):
    good = hashlib.sha256(PAYLOAD).hexdigest()
    mm = mod.ModelManager(str(tmp_path / "cache"))
    seen = []
    path = mm.ensure("lid.bin", source.as_uri(), sha256=good,
                     progress=lambda done, total: seen.append((done, total)))
    assert path == str(mm.local_path("lid.bin"))
    assert open(path, "rb").read() == PAYLOAD
    assert seen[-1] == (len(PAYLOAD), len(PAYLOAD)) and len(seen) == 3
    assert mm.is_cached("lid.bin", good)
    source.unlink()  # cached now: no download
    assert mm.ensure("lid.bin", source.as_uri(), sha256=good) == path
    assert not list((tmp_path / "cache").glob("*.part"))


@pytest.mark.parametrize("mod", [tmm, jmm], ids=["port", "jax"])
def test_ensure_refuses_a_bad_checksum_and_a_missing_source(tmp_path, source, mod):
    mm = mod.ModelManager(str(tmp_path / "cache"))
    assert mm.ensure("lid.bin", source.as_uri(), sha256="0" * 64) is None
    assert not mm.local_path("lid.bin").exists()
    assert not list((tmp_path / "cache").glob("*"))
    assert mm.ensure("x.bin", (tmp_path / "nope.bin").as_uri()) is None
    assert not mm.local_path("x.bin").exists()


def test_cached_file_with_another_checksum_is_discarded_as_jax(tmp_path, source):
    good = hashlib.sha256(PAYLOAD).hexdigest()
    for mod in (tmm, jmm):
        mm = mod.ModelManager(str(tmp_path / mod.__name__))
        assert not mm.is_cached("lid.bin")
        mm.cache_dir.mkdir(parents=True)
        mm.local_path("lid.bin").write_bytes(b"stale")
        assert mm.is_cached("lid.bin")  # no checksum given: kept
        assert not mm.is_cached("lid.bin", good)
        assert not mm.local_path("lid.bin").exists()
        assert mm.ensure("lid.bin", source.as_uri(), sha256=good) == str(mm.local_path("lid.bin"))


def test_default_cache_dir_equals_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path))
    assert tmm.ModelManager().cache_dir == jmm.ModelManager().cache_dir == \
        tmp_path / ".cache" / "radiant_tpu" / "models"
