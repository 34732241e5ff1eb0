"""Port parity of the DROID factory's host modules (`mvtracker_torch/droid/`:
transforms, gripper, pipeline, quality, hub) against the JAX package's, on
the same seeded inputs: numpy on both sides, so every comparison is exact.
The raw episodes are written by h5py, which the port reads with its own
HDF5 reader."""

import json
import os

import numpy as np
import pytest

from mvtracker_torch.droid import gripper as t_gripper
from mvtracker_torch.droid import hub as t_hub
from mvtracker_torch.droid import pipeline as t_pipe
from mvtracker_torch.droid import quality as t_quality
from mvtracker_torch.droid import transforms as t_tf
from mvtracker_tpu.droid import gripper as j_gripper
from mvtracker_tpu.droid import hub as j_hub
from mvtracker_tpu.droid import pipeline as j_pipe
from mvtracker_tpu.droid import quality as j_quality
from mvtracker_tpu.droid import transforms as j_tf
from tests.test_droid import make_episode


def _same(a, b, path=""):
    """Exact equality of nested dicts / lists / arrays / scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (np.ndarray, np.generic)) or isinstance(b, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def test_transforms_match_jax(rng):
    rpy = rng.uniform(-np.pi, np.pi, size=(20, 3))
    _same(t_tf.euler_xyz_to_matrix(rpy), j_tf.euler_xyz_to_matrix(rpy))
    for rv in (rng.normal(size=3), np.zeros(3), np.full(3, 1e-13)):
        _same(t_tf.rotvec_to_matrix(rv), j_tf.rotvec_to_matrix(rv))
    p = rng.normal(size=(7, 6))
    _same(t_tf.pose6_to_T(p[0]), j_tf.pose6_to_T(p[0]))
    _same(t_tf.pose6_to_T_batch(p), j_tf.pose6_to_T_batch(p))
    _same(t_tf.rvec_tvec_to_matrix(p[1]), j_tf.rvec_tvec_to_matrix(p[1]))
    tracks = rng.uniform(-0.5, 0.5, (6, 9, 3)) + [0.0, 0.0, 1.0]
    k = t_tf.estimate_zed_intrinsics(320, 240)
    _same(k, j_tf.estimate_zed_intrinsics(320, 240))
    poses = t_tf.pose6_to_T_batch(0.1 * rng.normal(size=(6, 6)))
    for pose in (poses[0], poses):
        for clip in (False, True):
            _same(t_tf.project_tracks_to_2d(tracks, k, pose, 320, 240, clip_to_bounds=clip),
                  j_tf.project_tracks_to_2d(tracks, k, pose, 320, 240, clip_to_bounds=clip))


def _binary_stl(path, rng, n=60):
    """A binary STL whose faces straddle the pad plane y = -0.0095."""
    tri = rng.uniform(-0.02, 0.0, (n, 3, 3)).astype("<f4")
    with open(path, "wb") as f:
        f.write(b"\0" * 80 + np.uint32(n).tobytes())
        for t in tri:
            f.write(np.zeros(3, "<f4").tobytes() + t.tobytes() + b"\0\0")


@pytest.mark.parametrize("mesh", [False, True])
def test_gripper_fk_matches_jax(tmp_path, rng, mesh):
    path = None
    if mesh:
        path = str(tmp_path / "finger.stl")
        _binary_stl(path, rng)
        _same(t_gripper.load_binary_stl(path), j_gripper.load_binary_stl(path))
        v, f = t_gripper.load_binary_stl(path)
        _same(t_gripper.extract_contact_pad_vertices(v, f), j_gripper.extract_contact_pad_vertices(v, f))
    _same(t_gripper.synthetic_contact_pad(13), j_gripper.synthetic_contact_pad(13))
    tt, tj = t_gripper.ContactSurfaceTracker(9, path), j_gripper.ContactSurfaceTracker(9, path)
    _same(tt.contact_points_local, tj.contact_points_local)
    ee = t_tf.pose6_to_T(rng.normal(size=6))
    for g in (0.0, 0.37, np.array([1.0])):
        _same(t_gripper.compute_finger_transforms(ee, g), j_gripper.compute_finger_transforms(ee, g))
        _same(tt.contact_points_and_frames(ee, g), tj.contact_points_and_frames(ee, g))


def test_normalized_flow_matches_jax(rng):
    t = 40
    c = np.cumsum(rng.normal(0, 0.002, (t, 3)), axis=0)
    frames = np.tile(np.eye(4), (t, 1, 1)) + rng.normal(0, 0.01, (t, 4, 4))
    tracks = rng.normal(size=(t, 5, 3))
    for args in ((c, frames), (c[:1], frames[:1]), (np.zeros((t, 3)), frames)):
        _same(t_pipe.compute_normalized_flow(*args, tracks_3d=tracks[:len(args[0])]),
              j_pipe.compute_normalized_flow(*args, tracks_3d=tracks[:len(args[0])]))


def test_pipeline_stages_match_jax(tmp_path):
    ep = make_episode(tmp_path, t=20)
    h5 = os.path.join(ep, "trajectory.h5")
    with open(os.path.join(ep, "metadata.json")) as f:
        meta = json.load(f)
    for mf in (None, 7):
        tt, tj = t_pipe.generate_tracks(h5, 6, mf), j_pipe.generate_tracks(h5, 6, mf)
        _same(tt, tj)
        kw = dict(wrist_cam_serial="200", wrist_cam_extrinsics=meta["wrist_cam_extrinsics"], max_frames=mf)
        et, ej = t_pipe.compute_extrinsics(h5, meta["cam2base"], **kw), j_pipe.compute_extrinsics(h5, meta["cam2base"], **kw)
        _same(et, ej)
        _same(t_pipe.compute_2d_tracks(tt["tracks_3d"], meta["camera_intrinsics"], et),
              j_pipe.compute_2d_tracks(tj["tracks_3d"], meta["camera_intrinsics"], ej))


def test_process_episode_outputs_match_jax(tmp_path):
    ep = make_episode(tmp_path, t=25)
    outs = {}
    for name, mod in (("t", t_pipe), ("j", j_pipe)):
        out_dir = str(tmp_path / name)
        result = mod.process_episode(ep, out_dir, num_track_points=8)
        assert mod.process_episode(ep, out_dir)["status"] == "skipped"
        with open(os.path.join(out_dir, "quality.json")) as f:
            quality = json.load(f)
        outs[name] = (result, quality, *(dict(np.load(os.path.join(out_dir, n))) for n in ("tracks.npz", "extrinsics.npz")))
    _same(outs["t"], outs["j"])


def test_quality_and_hub_match_jax(tmp_path):
    t6 = [0.0] * 6
    cam2base = {
        "LABA+s1+2023-01-01-01h-01m-01s": {"100": t6, "101": t6},
        "LABA+s1+2023-01-01-02h-02m-02s": {"100": t6},
        "LABB+s2+2023-01-02-01h-01m-01s": {"100": t6, "101": t6, "102": t6},
        "LABB+s2+2023-01-02-02h-02m-02s": {"100": [0.0] * 3},
        "LABC+s3+2023-01-03-01h-01m-01s": {},
        "not-an-episode": {"100": t6},
    }
    for limit in (-1, 2, 10):
        assert t_quality.order_episodes_by_quality(cam2base, limit) == j_quality.order_episodes_by_quality(cam2base, limit)
    path = tmp_path / "cam2base.json"
    path.write_text(json.dumps(cam2base))
    assert t_quality.order_episodes_from_file(str(path)) == j_quality.order_episodes_from_file(str(path))
    for key in list(cam2base) + ["a+b", "a+b+c+d"]:
        assert t_quality.parse_episode_key(key) == j_quality.parse_episode_key(key)
    for data in cam2base.values():
        assert t_quality.episode_quality(data) == j_quality.episode_quality(data)

    # Stores: the same operations leave the same trees.
    listings = {}
    for name, hub in (("t", t_hub), ("j", j_hub)):
        root = tmp_path / name
        store = hub.LocalStore(str(root / "store"))
        for i in range(3):
            ep = root / f"ep{i}"
            ep.mkdir(parents=True)
            (ep / "tracks.npz").write_bytes(bytes([i]) * 7)
        up = hub.BatchUploader(store, str(root / "staging"), batch_size=2, interval_s=9999)
        for i in range(3):
            up.stage(str(root / f"ep{i}"), f"ep{i}")
        status = [up.status()]
        up.close()
        status.append(up.status())
        got = hub.download_episode(store, "ep1", str(root / "dl"))
        listings[name] = (status, store.list_keys(), hub.episode_available(store, "ep2"),
                          hub.episode_available(store, "ep2", skip_check=True), sorted(os.listdir(got)),
                          (root / "dl" / "ep1" / "tracks.npz").read_bytes())
    assert listings["t"] == listings["j"]


def test_hf_store_reports_a_missing_client(monkeypatch):
    """`HfStore` imports huggingface_hub inside a guarded import; without it
    the error names the missing client (as the JAX package's)."""
    import builtins

    real = builtins.__import__

    def fake(name, *args, **kwargs):
        if name.startswith("huggingface_hub"):
            raise ImportError("no huggingface_hub")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", fake)
    with pytest.raises(ImportError, match="huggingface_hub is not installed"):
        t_hub.HfStore("org/repo")


def test_process_episodes_batch_spawned_workers(tmp_path):
    """Two spawned workers process two episodes, as the JAX package's batch."""
    eps = []
    for i in range(2):
        parent = tmp_path / f"e{i}"
        parent.mkdir()
        ep = make_episode(parent, t=10)
        dst = os.path.join(os.path.dirname(ep), f"episode_{i:03d}")
        os.rename(ep, dst)
        eps.append(dst)
    out = str(tmp_path / "out")
    results = t_pipe.process_episodes_batch(eps, out, num_workers=2, num_track_points=6)
    assert results == {"ok": 2, "skipped": 0, "failed": 0}
    for ep in eps:
        key = os.path.basename(ep)
        want = j_pipe.process_episode(ep, str(tmp_path / "want" / key), num_track_points=6)
        with open(os.path.join(out, key, "quality.json")) as f:
            assert json.load(f) == {k: v for k, v in want.items() if k not in ("status", "episode")}
        _same(dict(np.load(os.path.join(out, key, "tracks.npz"))),
              dict(np.load(str(tmp_path / "want" / key / "tracks.npz"))))
    assert t_pipe.process_episodes_batch(eps, out, num_workers=2, num_track_points=6)["skipped"] == 2


def _suicidal_worker(ep, out_root, kwargs):
    """The 'die' episode SIGKILLs its worker on the first attempt."""
    import signal

    marker = os.path.join(out_root, "died_once")
    if "die" in ep and not os.path.exists(marker):
        with open(marker, "w") as f:
            f.write("x")
        os.kill(os.getpid(), signal.SIGKILL)
    return {"status": "ok"}


def _always_dies(ep, out_root, kwargs):
    import signal

    if "die" in ep:
        os.kill(os.getpid(), signal.SIGKILL)
    return {"status": "ok"}


def _raises(ep, out_root, kwargs):
    if "bad" in ep:
        raise RuntimeError("broken episode")
    return {"status": "ok"}


@pytest.mark.parametrize("worker,eps,want", [
    (_suicidal_worker, ["ep_a", "ep_die", "ep_b", "ep_c", "ep_d"], {"ok": 5, "skipped": 0, "failed": 0}),
    # Alone in its batch: an episode in flight beside it when the pool
    # breaks is retried too, and twice caught so would count as failed.
    (_always_dies, ["ep_die"], {"ok": 0, "skipped": 0, "failed": 1}),
    (_raises, ["ep_a", "ep_bad", "ep_b", "ep_c", "ep_d"], {"ok": 4, "skipped": 0, "failed": 1}),
])
def test_batch_isolates_failed_and_killed_workers(tmp_path, worker, eps, want):
    """A worker that dies is retried in a fresh pool (once more), one that
    raises is logged; the rest of the batch goes on."""
    out = str(tmp_path / "out")
    assert t_pipe.process_episodes_batch(eps, out, num_workers=2, worker_fn=worker) == want
    log = (tmp_path / "out" / "failed_episodes.txt")
    if worker is _raises:
        assert "broken episode" in log.read_text()
    else:
        assert "pool broken" in log.read_text()
    if worker is _always_dies:
        assert "died on every attempt" in log.read_text()


def test_batch_in_one_process(tmp_path):
    out = str(tmp_path / "out")
    assert t_pipe.process_episodes_batch(["ep_a", "ep_bad"], out, num_workers=1, worker_fn=_raises) == {
        "ok": 1, "skipped": 0, "failed": 1}
