"""The port's native replay record store (`data/native_store.py`, its own
copy of `native/replay_store.cpp`) and `TaskUniformReplay(storage="native")`
against the JAX package's.

Exact checks throughout: the codec's bytes, the files on disk, and every
array of every sampled transition bit for bit. Transitions come from the
port's `fill_replay` on synthetic demos (16², stub language model) and go
into both packages' replays, so the comparison is of the stores, not of
the two fill functions (test_torch_train.py holds those to each other).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from manigaussian_tpu.data import native_store as jns
from manigaussian_tpu.data.replay import TaskUniformReplay as JReplay
from manigaussian_tpu_torch.data import native_store as tns
from manigaussian_tpu_torch.data.language import create_language_model
from manigaussian_tpu_torch.data.pipeline import fill_replay
from manigaussian_tpu_torch.data.replay import TaskUniformReplay
from manigaussian_tpu_torch.data.synthetic import generate_task

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASKS = ("open_drawer", "close_jar")


@pytest.fixture(scope="module")
def transitions(tmp_path_factory):
    """{task: [transition, ...]} from the port's fill_replay."""
    assert tns.load_library() is not None, "g++ is needed to build the store"
    root = str(tmp_path_factory.mktemp("demos"))
    out = {}
    for task in TASKS:
        generate_task(root, task, num_episodes=2, timesteps=12, h=16, w=16,
                      nerf_views=3, nerf_hw=16)
        mem = TaskUniformReplay()
        fill_replay(mem, root, task, 2, ("front",),
                    (-0.3, -0.5, 0.6, 0.7, 0.5, 1.6), 100, 5, 15,
                    create_language_model("stub"))
        out[task] = mem._mem[task]
    return out


def _assert_same(a, b):
    """Equal transitions. A numpy scalar (`reward`, `terminal`; the pickle
    layout keeps it) equals the [1] array the codec returns for it: both
    packages' encoders pass it through `np.ascontiguousarray`, which makes
    a 0-d array 1-d. No batch reads those two keys."""
    assert set(a) == set(b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, (np.ndarray, np.generic)):
            x, y = np.asarray(x), np.asarray(y)
            if {x.shape, y.shape} == {(), (1,)}:
                x, y = x.reshape(1), y.reshape(1)
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert np.array_equal(x, y), k
        else:
            assert x == y, k


def _fill(replay, transitions):
    for task, trs in transitions.items():
        for tr in trs:
            replay.add(task, tr)
    replay.flush()


def test_codec_bytes_equal_jax(transitions):
    for tr in [t for trs in transitions.values() for t in trs[:2]]:
        blob = tns.encode_transition(tr)
        assert blob == jns.encode_transition(tr)
        _assert_same(tns.decode_transition(memoryview(blob)),
                     jns.decode_transition(memoryview(blob)))


def test_stores_are_the_same_bytes_both_ways(tmp_path, transitions):
    recs = [tns.encode_transition(t) for t in transitions["open_drawer"]]
    recs += [b"", b"x" * 4097]
    paths = {}
    for name, mod in (("jax", jns), ("torch", tns)):
        store = mod.NativeRecordStore(str(tmp_path / name / "records"))
        for r in recs:
            store.append(r)
        store.close()
        paths[name] = tmp_path / name
    for suffix in ("records.bin", "records.idx"):
        assert ((paths["jax"] / suffix).read_bytes()
                == (paths["torch"] / suffix).read_bytes())
    for writer, reader in (("jax", tns), ("torch", jns)):
        store = reader.NativeRecordStore(str(paths[writer] / "records"))
        assert len(store) == len(recs)
        assert [bytes(store.get(i)) for i in range(len(recs))] == recs
        store.close()


def test_native_replay_samples_match_jax_and_pickle(tmp_path, transitions):
    port = TaskUniformReplay(save_dir=str(tmp_path / "port"))
    jax_ = JReplay(save_dir=str(tmp_path / "jax"), storage="native")
    pick = TaskUniformReplay(save_dir=str(tmp_path / "pickle"),
                             storage="pickle")
    assert port.storage == jax_.storage == "native"
    for r in (port, jax_, pick):
        _fill(r, transitions)
    assert os.path.isfile(tmp_path / "port" / "open_drawer" / "records.idx")
    assert not list((tmp_path / "port" / "open_drawer").glob("*.replay"))
    # each package reads the directory the other wrote
    port_reads_jax = TaskUniformReplay(save_dir=str(tmp_path / "jax"))
    jax_reads_port = JReplay(save_dir=str(tmp_path / "port"), storage="native")
    for r in (port_reads_jax, jax_reads_port):
        r.reload_from_disk()
    replays = (port, jax_, pick, port_reads_jax, jax_reads_port)
    for shard in ((0, 1), (1, 2)):
        for r in replays:
            r.rank, r.num_replicas = shard
        draws = [r.sample(6, np.random.default_rng(3)) for r in replays]
        for batch in draws[1:]:
            for a, b in zip(draws[0], batch):
                _assert_same(a, b)
    assert {s["task"] for s in draws[0]} == set(TASKS)


def test_reload_from_disk_finds_both_layouts(tmp_path, transitions):
    native = TaskUniformReplay(save_dir=str(tmp_path))
    native.add("open_drawer", transitions["open_drawer"][0])
    native.add("open_drawer", transitions["open_drawer"][1])
    native.flush()
    pick = TaskUniformReplay(save_dir=str(tmp_path), storage="pickle")
    for tr in transitions["close_jar"][:3]:
        pick.add("close_jar", tr)
    again = TaskUniformReplay(save_dir=str(tmp_path))
    again.reload_from_disk()
    assert again.tasks == sorted(TASKS)
    assert again.size("open_drawer") == 2 and again.size("close_jar") == 3
    _assert_same(again._get("open_drawer", 1), transitions["open_drawer"][1])
    _assert_same(again._get("close_jar", 2), transitions["close_jar"][2])


def test_decoded_arrays_outlive_their_mapping(tmp_path, transitions):
    """No array a `get` returns is a view into the mmap: appending (which
    remaps the reader at the next read) and closing leave them intact."""
    trs = transitions["open_drawer"]
    replay = TaskUniformReplay(save_dir=str(tmp_path))
    replay.add("open_drawer", trs[0])
    got = replay._get("open_drawer", 0)
    arrays = {k: v for k, v in got.items()
              if isinstance(v, np.ndarray) and v.dtype != object}
    assert arrays and all(v.flags.owndata and v.flags.writeable
                          for v in arrays.values())
    replay.add("open_drawer", trs[1])
    replay._get("open_drawer", 1)                    # remaps the reader
    replay._stores["open_drawer"].close()
    _assert_same(got, trs[0])


def test_dp_ranks_fill_their_own_stores(tmp_path):
    """`--mesh 2` with the default `replay.use_disk=true`: each rank writes
    its own record store (`replay.path` + `_p<rank>`) and trains from it."""
    from tests.test_torch_parallel_cli import MICRO_CLI
    overrides = [o for o in MICRO_CLI if not o.startswith(
        ("replay.use_disk", "framework.training_iterations"))]
    rp = str(tmp_path / "rp")
    out = subprocess.run(
        [sys.executable, "-m", "manigaussian_tpu_torch.train", "--cpu",
         "--mesh", "2", "--demo-root", str(tmp_path / "demos"),
         "--logdir", str(tmp_path / "logs"), "--synthetic", *overrides,
         "replay.use_disk=true", f"replay.path={rp}",
         "framework.training_iterations=2"],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    for rank in (0, 1):
        d = f"{rp}_p{rank}/open_drawer"
        assert os.path.isfile(f"{d}/records.idx"), os.listdir(f"{rp}_p{rank}")
        assert not [f for f in os.listdir(d) if f.endswith(".replay")]
        n = TaskUniformReplay(save_dir=f"{rp}_p{rank}")
        n.reload_from_disk()
        assert n.size() > 0
    # the two ranks share the stream, so their lines may interleave
    dec, tag, runs, at = json.JSONDecoder(), "[train] run ", [], 0
    while (at := out.stdout.find(tag, at)) >= 0:
        run, at = dec.raw_decode(out.stdout, at + len(tag))
        runs.append(run)
    assert len(runs) == 2 and all(r["params_equal_across_ranks"] for r in runs)
