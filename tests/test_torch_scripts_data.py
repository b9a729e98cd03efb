"""The port's user scripts for data and campaigns against the JAX package's
scripts on the CPU: `gen_demonstrations` (synthetic episodes file for file,
the NeRF view recorder on fake callables, the RLBench backend's exit text
without a simulator) and `flagship_campaign` (its config and its `collect`:
summary.json's keys and values, and a resumed run's merged curve, against
the JAX script's pandas version on the same logs). Also: the scripts run
with jax, flax, pandas and the JAX package unimportable.

Exact checks throughout, except the merged curve CSVs, which are compared
as numbers to 1e-15 relative: pandas' default CSV parser reads a decimal
to within an ulp, and the JAX script writes back what it read.
"""

import csv
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from manigaussian_tpu_torch.scripts import flagship_campaign as fc
from manigaussian_tpu_torch.scripts import gen_demonstrations as gd
from tests.torch_port_helpers import jax_script, torch_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_ARGS = ["--tasks", "open_drawer", "turn_tap", "--episodes_per_task", "2",
            "--image_size", "16", "--nerf_views", "2", "--timesteps", "6"]


def same_tree(a: str, b: str) -> list:
    """Relative file paths under two directories whose bytes differ, or
    that only one of them holds."""
    def files(root):
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, fs in os.walk(root) for f in fs}

    fa, fb = files(a), files(b)
    diff = sorted(fa ^ fb)
    for rel in sorted(fa & fb):
        with open(os.path.join(a, rel), "rb") as x, \
                open(os.path.join(b, rel), "rb") as y:
            if x.read() != y.read():
                diff.append(rel)
    return diff


def test_synthetic_episodes_equal_jax_file_for_file(tmp_path, monkeypatch):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    monkeypatch.setattr(sys, "argv", ["gen_demonstrations.py", *GEN_ARGS,
                                      "--save_path", jd])
    jax_script("gen_demonstrations").main()
    gd.main([*GEN_ARGS, "--save_path", td])
    assert os.listdir(jd) and same_tree(jd, td) == []


def test_nerf_recorder_keeps_jax_views():
    jrec_cls = jax_script("gen_demonstrations").NerfDemoRecorder
    poses = np.random.default_rng(0).standard_normal((50, 4, 4))
    intr = np.eye(3, dtype=np.float32)

    def capture(i):
        return (np.full((4, 4, 3), i, np.uint8),
                np.full((4, 4), float(i), np.float32), poses[i], intr)

    recs = []
    for cls in (jrec_cls, gd.NerfDemoRecorder):
        stepped = []
        rec = cls(capture, lambda: stepped.append(1), num_motion_steps=50,
                  keep_lo=20, keep_hi=40)
        for _ in range(3):
            rec.take_snap()
        recs.append((rec.pop_episode(), len(stepped), rec.t))
    (jep, jn, jt), (tep, tn, tt) = recs
    assert sorted(tep) == sorted(jep) == [0, 1, 2]
    assert tn == jn == 63 and tt == jt == 0
    for t in jep:
        for a, b in zip(tep[t], jep[t]):
            np.testing.assert_array_equal(a, b)
    assert tep[0][0][0, 0, 0, 0] == 20 and tep[0][0][-1, 0, 0, 0] == 40


def test_rlbench_backend_exits_as_jax_without_a_simulator(tmp_path,
                                                          monkeypatch):
    args = [*GEN_ARGS[:2], "--save_path", str(tmp_path), "--backend",
            "rlbench"]
    monkeypatch.setattr(sys, "argv", ["gen_demonstrations.py", *args])
    with pytest.raises(SystemExit) as jexit:
        jax_script("gen_demonstrations").main()
    with pytest.raises(SystemExit) as texit:
        gd.main(args)
    assert str(texit.value) == str(jexit.value)
    assert "Use --backend synthetic" in str(texit.value)


@pytest.mark.parametrize("variant,resume", [("w_geo", False),
                                            ("w_geo_sem_dyna", True)])
def test_campaign_config_equals_jax(variant, resume, monkeypatch):
    jfc = jax_script("r5_flagship_campaign")
    monkeypatch.setattr(jfc, "WORK", "/w")
    jcfg = jfc.build_cfg(variant, 2010, resume=resume)
    tcfg = fc.build_cfg(variant, 2010, resume=resume, work="/w")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(torch_config(jcfg))


def _fake_log(logdir, steps, seed, blank=None):
    """A runner's log dir: train_data.csv at `steps`, recon panels every
    10 steps, config.json. `blank`: (row, column) left empty."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(logdir, "recon"), exist_ok=True)
    cols = ["step", "total_loss", "bc_loss", "rgb_loss", "dyna_loss", "psnr",
            "overflow_splats", "overflow_gaussians", "steps_per_s"]
    with open(os.path.join(logdir, "train_data.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(cols)
        for i, s in enumerate(steps):
            row = [s] + [float(x) for x in rng.uniform(0, 20, len(cols) - 1)]
            if blank and blank[0] == i:
                row[cols.index(blank[1])] = ""
            w.writerow(row)
    for s in steps:
        if s % 10 == 0:
            Image.fromarray(np.full((4, 4, 3), s, np.uint8)).save(
                os.path.join(logdir, "recon", f"{s}.png"))
    with open(os.path.join(logdir, "config.json"), "w") as f:
        json.dump({"seed": seed}, f)


def _same_summary(a, b):
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], dict):
            _same_summary(a[k], b[k])
        elif isinstance(b[k], float) and math.isnan(b[k]):
            assert math.isnan(a[k]), k
        else:
            assert a[k] == b[k], (k, a[k], b[k])


def _table(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return {k: [float(r[k]) if r[k] else math.nan for r in rows]
            for k in rows[0]}


def test_campaign_collect_equals_jax(tmp_path, monkeypatch):
    """summary.json and the artifact directory of a first run and of a
    resumed one (its fresh CSV from step 30 merged into the first's)."""
    jfc = jax_script("r5_flagship_campaign")
    jout, tout = str(tmp_path / "jax_out"), str(tmp_path / "torch_out")
    monkeypatch.setattr(jfc, "OUT", jout)
    feed = {"transitions": 36, "batches_per_s": 14.0, "ms_per_batch": 71.4,
            "batch_size": 1}
    runs = [(list(range(0, 41, 2)), 0, (3, "psnr")),
            (list(range(30, 61, 2)), 1, (2, "rgb_loss"))]
    for n, (steps, seed, blank) in enumerate(runs):
        logdir = str(tmp_path / f"log{n}")
        _fake_log(logdir, steps, seed, blank)
        js = jfc.collect("w_geo", logdir, feed, 12.3, 456.7)
        ts = fc.collect("w_geo", logdir, feed, 12.3, 456.7, out_root=tout)
        _same_summary(ts, js)
        assert js["nonfinite_cells"] == n + 1
        _same_summary(json.load(open(os.path.join(tout, "w_geo",
                                                  "summary.json"))), js)
        jt = _table(os.path.join(jout, "w_geo", "train.csv"))
        tt = _table(os.path.join(tout, "w_geo", "train.csv"))
        assert list(tt) == list(jt)
        for k in jt:
            np.testing.assert_allclose(tt[k], jt[k], rtol=1e-15, atol=0,
                                       err_msg=k)
    assert sorted(os.listdir(os.path.join(tout, "w_geo"))) == \
        sorted(os.listdir(os.path.join(jout, "w_geo")))
    assert ts["iterations"] == 61 and ts["logged_rows"] == 31


def test_scripts_run_without_jax_flax_or_pandas(tmp_path):
    """The scripts' work, not only their imports, in a process where jax,
    flax, pandas, msgpack and the JAX package cannot be imported:
    synthetic demos, the goldens on the CPU, a campaign collect, and a
    GPU request that fails once without a GPU."""
    log = str(tmp_path / "log")
    _fake_log(log, list(range(0, 21, 2)), 0)
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'pandas', 'msgpack',\n"
        "          'manigaussian_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "from manigaussian_tpu_torch.scripts import (flagship_campaign,\n"
        "    gen_demonstrations, make_goldens)\n"
        f"t = {str(tmp_path)!r}\n"
        "gen_demonstrations.main(['--tasks', 'open_drawer',\n"
        "    '--save_path', t + '/d', '--episodes_per_task', '1',\n"
        "    '--image_size', '16', '--nerf_views', '1', '--timesteps', '4'])\n"
        "make_goldens.main(['--out', t + '/g', '--cpu'])\n"
        f"s = flagship_campaign.collect('w_geo', {log!r}, {{}}, 0.0, 1.0,\n"
        "                               out_root=t + '/o')\n"
        "assert s['iterations'] == 21, s\n"
        "try:\n"
        "    make_goldens.main(['--out', t + '/g2'])\n"
        "except RuntimeError as e:\n"
        "    assert 'CUDA' in str(e)\n"
        "else:\n"
        "    raise AssertionError('no GPU and no --cpu ran')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), \
        out.stdout + out.stderr


def test_recon_panel_is_the_images_under_their_titles(tmp_path):
    """`utils/visualization.save_recon_panel` (Pillow): the given images
    side by side at the first one's height below a title strip, the
    embeddings normalized to [0, 1], a batch's first image taken."""
    from manigaussian_tpu_torch.utils.visualization import (_TITLE_H,
                                                            save_recon_panel)
    rng = np.random.default_rng(0)
    rgb = rng.uniform(size=(1, 8, 8, 3)).astype(np.float32)
    gt = rng.uniform(size=(8, 8, 3)).astype(np.float32)
    embed = rng.normal(size=(8, 8, 3)).astype(np.float32)
    path = save_recon_panel(str(tmp_path), 7, input_rgb=rgb, gt_rgb=gt,
                            pred_embed=embed)
    assert path == os.path.join(str(tmp_path), "recon", "7.png")
    img = np.asarray(Image.open(path).convert("RGB"))
    assert img.shape == (8 + _TITLE_H, 24, 3)
    quant = lambda x: (np.clip(x, 0, 1) * 255).round().astype(np.uint8)
    e01 = (embed - embed.min()) / (embed.max() - embed.min())
    np.testing.assert_array_equal(img[_TITLE_H:, :8], quant(rgb[0]))
    np.testing.assert_array_equal(img[_TITLE_H:, 8:16], quant(gt))
    np.testing.assert_array_equal(img[_TITLE_H:, 16:], quant(e01))
    assert (img[:_TITLE_H] < 128).any()       # the titles drawn
