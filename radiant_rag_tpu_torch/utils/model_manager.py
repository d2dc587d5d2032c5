"""Model artifact manager: download with progress, SHA-256 verification
and a local cache.

The port's copy of `radiant_rag_tpu/utils/model_manager.py` (host code,
no device work). `ensure` downloads through `urllib` when the file is not
cached (or its checksum is off) and keeps it only if its SHA-256 matches;
it returns None when the download fails.
"""

from __future__ import annotations

import hashlib
import logging
import os
import urllib.request
from pathlib import Path
from typing import Callable, Optional

logger = logging.getLogger(__name__)


def sha256_file(path: str, chunk_size: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            block = fh.read(chunk_size)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


class ModelManager:
    def __init__(self, cache_dir: str = "~/.cache/radiant_tpu/models") -> None:
        self.cache_dir = Path(os.path.expanduser(cache_dir))

    def local_path(self, name: str) -> Path:
        return self.cache_dir / name

    def is_cached(self, name: str, sha256: Optional[str] = None) -> bool:
        """True when the file is there (and matches `sha256`, when given);
        a cached file with another checksum is deleted."""
        p = self.local_path(name)
        if not p.is_file():
            return False
        if sha256 and sha256_file(str(p)) != sha256:
            logger.warning("checksum mismatch for cached %s; discarding", name)
            p.unlink()
            return False
        return True

    def ensure(self, name: str, url: str, sha256: Optional[str] = None,
               progress: Optional[Callable[[int, int], None]] = None) -> Optional[str]:
        """A local path of `name`, downloaded from `url` if needed; None if
        the download fails or its checksum is off."""
        if self.is_cached(name, sha256):
            return str(self.local_path(name))
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        target = self.local_path(name)
        tmp = str(target) + ".part"
        try:
            req = urllib.request.Request(url, headers={"User-Agent": "radiant-tpu/0.1"})
            with urllib.request.urlopen(req, timeout=60) as resp, open(tmp, "wb") as out:
                total = int(resp.headers.get("Content-Length", 0) or 0)
                done = 0
                while True:
                    block = resp.read(1 << 20)
                    if not block:
                        break
                    out.write(block)
                    done += len(block)
                    if progress:
                        progress(done, total)
            if sha256 and sha256_file(tmp) != sha256:
                os.unlink(tmp)
                logger.error("downloaded %s failed checksum verification", name)
                return None
            os.replace(tmp, target)
            return str(target)
        except Exception as exc:
            logger.warning("download of %s failed: %s", name, exc)
            if os.path.exists(tmp):
                os.unlink(tmp)
            return None
