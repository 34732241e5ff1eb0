"""Artifact-hub plumbing for the DROID factory, counterpart of
`mvtracker_tpu/droid/hub.py`.

Re-design of the reference's HuggingFace upload/availability machinery
(`conversions/droid/utils/auth_hf.py`, `check_episode_availability.py`,
`download_single_episode.py`, and the periodic batch-upload loop in
`run_pipeline_cluster_huggingface_compressed_lossy.sh:950`):

- `ArtifactStore` is the transport abstraction: `LocalStore` (filesystem,
  fully functional and used in tests) and `HfStore` (thin wrapper over
  `huggingface_hub` when installed — this container is zero-egress, so it
  is import-gated).
- `BatchUploader` stages per-episode outputs and flushes them in batches on
  an interval or size threshold, with failure isolation and an upload log —
  the shell orchestrator's background uploader as a real component.
- `episode_available` / `download_episode` mirror the availability check
  and single-episode fetch (skippable via `skip_check`, the reference's
  SKIP_HF_CHECK).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from typing import Optional


class ArtifactStore:
    """Transport interface: push/pull/list artifact trees by episode key."""

    def upload_dir(self, local_dir: str, remote_key: str):  # pragma: no cover
        raise NotImplementedError

    def download_dir(self, remote_key: str, local_dir: str):  # pragma: no cover
        raise NotImplementedError

    def exists(self, remote_key: str) -> bool:  # pragma: no cover
        raise NotImplementedError

    def list_keys(self) -> list[str]:  # pragma: no cover
        raise NotImplementedError


class LocalStore(ArtifactStore):
    """Filesystem-backed store (shared-disk clusters, tests)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key)

    def upload_dir(self, local_dir: str, remote_key: str):
        dst = self._path(remote_key)
        os.makedirs(os.path.dirname(dst) or self.root, exist_ok=True)
        if os.path.exists(dst):
            shutil.rmtree(dst)
        shutil.copytree(local_dir, dst)

    def download_dir(self, remote_key: str, local_dir: str):
        src = self._path(remote_key)
        if not os.path.exists(src):
            raise FileNotFoundError(remote_key)
        if os.path.exists(local_dir):
            shutil.rmtree(local_dir)
        shutil.copytree(src, local_dir)

    def exists(self, remote_key: str) -> bool:
        return os.path.exists(self._path(remote_key))

    def list_keys(self) -> list[str]:
        return sorted(
            d for d in os.listdir(self.root) if os.path.isdir(self._path(d))
        )


class HfStore(ArtifactStore):
    """HuggingFace dataset-repo store; requires `huggingface_hub`."""

    def __init__(self, repo_id: str, token: Optional[str] = None, create: bool = True):
        try:
            import huggingface_hub
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "huggingface_hub is not installed (zero-egress environment); "
                "use LocalStore or install the hub client"
            ) from e
        self._hub = huggingface_hub
        self.api = huggingface_hub.HfApi(token=token or os.environ.get("HF_TOKEN"))
        self.repo_id = repo_id
        if create:  # pragma: no cover
            self.api.create_repo(repo_id, repo_type="dataset", exist_ok=True)

    def upload_dir(self, local_dir, remote_key):  # pragma: no cover
        self.api.upload_folder(
            folder_path=local_dir, path_in_repo=remote_key,
            repo_id=self.repo_id, repo_type="dataset",
        )

    def download_dir(self, remote_key, local_dir):  # pragma: no cover
        self._hub.snapshot_download(
            self.repo_id, repo_type="dataset",
            allow_patterns=[f"{remote_key}/*"], local_dir=local_dir,
        )

    def exists(self, remote_key) -> bool:  # pragma: no cover
        files = self.api.list_repo_files(self.repo_id, repo_type="dataset")
        prefix = remote_key.rstrip("/") + "/"
        return any(f.startswith(prefix) for f in files)

    def list_keys(self) -> list[str]:  # pragma: no cover
        files = self.api.list_repo_files(self.repo_id, repo_type="dataset")
        return sorted({f.split("/")[0] for f in files if "/" in f})


def episode_available(store: ArtifactStore, episode_key: str, skip_check: bool = False) -> bool:
    """Availability check (reference `check_episode_availability.py`,
    skippable like SKIP_HF_CHECK)."""
    if skip_check:
        return False
    return store.exists(episode_key)


def download_episode(store: ArtifactStore, episode_key: str, out_dir: str) -> str:
    """Fetch one episode's artifacts (reference `download_single_episode.py`)."""
    dst = os.path.join(out_dir, episode_key)
    store.download_dir(episode_key, dst)
    return dst


class BatchUploader:
    """Stage episode outputs; flush in batches (size/interval), log failures.

    Mirrors the shell pipeline's background `batch_upload_loop`
    (`run_pipeline_...lossy.sh:950`) with per-episode failure isolation: a
    daemon timer thread flushes every `interval_s` even when no new work is
    staged (the shell loop uploads periodically regardless), and uploads run
    OUTSIDE the lock so `stage()`/`status()` never block on the network.
    """

    def __init__(
        self,
        store: ArtifactStore,
        staging_dir: str,
        batch_size: int = 8,
        interval_s: float = 600.0,
    ):
        self.store = store
        self.staging_dir = staging_dir
        self.batch_size = batch_size
        self.interval_s = interval_s
        os.makedirs(staging_dir, exist_ok=True)
        self._pending: list[str] = []
        self._lock = threading.Lock()
        self.uploaded: list[str] = []
        self.failed: list[str] = []
        self._stop = threading.Event()
        self._timer = threading.Thread(target=self._interval_loop, daemon=True)
        self._timer.start()

    def _interval_loop(self):
        while not self._stop.wait(self.interval_s):
            self.flush()

    def close(self):
        """Stop the timer and flush what remains."""
        self._stop.set()
        self._timer.join(timeout=5)
        self.flush()

    def stage(self, episode_dir: str, episode_key: str):
        dst = os.path.join(self.staging_dir, episode_key)
        if os.path.exists(dst):
            shutil.rmtree(dst)
        shutil.copytree(episode_dir, dst)
        with self._lock:
            self._pending.append(episode_key)
            do_flush = len(self._pending) >= self.batch_size
        if do_flush:
            self.flush()

    def flush(self):
        # Snapshot under the lock, upload outside it: each key leaves
        # _pending exactly once, so concurrent timer/stage flushes never
        # double-upload.
        with self._lock:
            batch = list(self._pending)
            self._pending.clear()
        for key in batch:
            src = os.path.join(self.staging_dir, key)
            try:
                self.store.upload_dir(src, key)
                ok = True
            except Exception:
                logging.exception("upload failed for %s", key)
                ok = False
                with open(os.path.join(self.staging_dir, "failed_uploads.txt"), "a") as f:
                    f.write(key + "\n")
            with self._lock:
                (self.uploaded if ok else self.failed).append(key)
            if ok:
                shutil.rmtree(src)

    def status(self) -> dict:
        with self._lock:
            return {
                "pending": len(self._pending),
                "uploaded": len(self.uploaded),
                "failed": len(self.failed),
            }
