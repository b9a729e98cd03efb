"""The port's `analysis/compute_results.py` (csv and numpy) against the JAX
package's (pandas) on eval CSVs with empty cells, a row with no return at
all, tied steps and tied best rows: the printed lines equal JAX's for
every `--method`, and `category_table` equals JAX's DataFrame column for
column (NaN where JAX has NaN).
"""

import numpy as np
import pytest

from manigaussian_tpu.analysis import compute_results as JR
from manigaussian_tpu_torch.analysis import compute_results as TR

HEADER = ["step", "eval_envs/return/open_drawer", "eval_envs/return/turn_tap",
          "eval_envs/return/stack_blocks", "eval_envs/mean_return",
          "eval_envs/length/open_drawer"]
SEEDS = [
    [[0, 10.0, "", 30.0, 20.0, 5], [1000, 40.0, 60.0, "", 50.0, 7],
     [2000, 40.0, 60.0, 50.0, 50.0, 6], [2000, "", "", "", "", 4],
     [1500, 100.0, 0.0, 50.0, 50.0, 3]],
    [[500, 0.0, 0.0, 0.0, 0.0, 9], [2500, 20.0, "", 80.0, 50.0, 8],
     [1000, 90.0, 90.0, 90.0, 90.0, 2]],
    [[0, 33.3, 66.7, 12.5, 37.5, 5], [100, 33.3, 66.7, 12.5, 37.5, 5]],
]


@pytest.fixture
def csvs(tmp_path):
    paths = []
    for i, rows in enumerate(SEEDS):
        p = tmp_path / f"seed{i}.csv"
        p.write_text("\n".join(",".join(str(c) for c in r)
                               for r in [HEADER] + rows) + "\n")
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("method", ["last", "best", "0", "1"])
def test_printed_lines_equal_jax(csvs, method, monkeypatch, capsys):
    argv = ["--file_paths", *csvs, "--method", method]
    monkeypatch.setattr("sys.argv", ["compute_results", *argv])
    JR.main()
    want = capsys.readouterr().out
    TR.main(argv)
    assert capsys.readouterr().out == want
    assert JR.aggregate(csvs, method)[2] == pytest.approx(
        TR.aggregate(csvs, method)[2], nan_ok=True)


def test_category_table_equals_jax(csvs):
    import pandas as pd
    for path in csvs:
        want = JR.category_table(pd.read_csv(path))
        got = TR.category_table(TR.read_csv(path))
        assert list(got) == list(want.columns)
        for col in want.columns:
            np.testing.assert_array_equal(got[col],
                                          want[col].to_numpy(np.float64))


def test_unknown_method_raises(csvs):
    with pytest.raises(ValueError, match="unknown method"):
        TR.aggregate(csvs, "median")
    assert TR.CAT_GROUP_TO_TASK["Occulusion"] == ["open_drawer"]
    assert TR.TASKS == JR.TASKS
