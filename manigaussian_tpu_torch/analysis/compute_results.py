"""Success-rate aggregation across seeds, tasks and checkpoints (port of
`manigaussian_tpu/analysis/compute_results.py`; reference
`scripts/compute_results.py:20-122`), with `csv` and numpy.

Per checkpoint row of an eval_data.csv: the mean of its 'return' columns
(empty cells skipped, as pandas' row mean skips NaN); per seed the row
chosen by `--method` (best: the largest mean; last: the row of the largest
step, the first one on a tie; N: row N by position); then mean ± population
std over the seeds. `category_table` groups the tasks as the paper does.

Usage:
    python -m manigaussian_tpu_torch.analysis.compute_results \\
        --file_paths seed0.csv seed1.csv seed2.csv --method last
"""

from __future__ import annotations

import argparse
import csv
import warnings
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np

TASKS = ['close_jar', 'open_drawer', 'sweep_to_dustpan_of_size',
         'meat_off_grill', 'turn_tap', 'slide_block_to_color_target',
         'put_item_in_drawer', 'reach_and_drag', 'push_buttons', 'stack_blocks']

CAT_GROUP_TO_TASK = OrderedDict({
    'Planning': ['push_buttons', 'meat_off_grill'],
    'Long': ['stack_blocks', 'put_item_in_drawer'],
    'Tools': ['slide_block_to_color_target', 'reach_and_drag',
              'sweep_to_dustpan_of_size'],
    'Motion': ['turn_tap'],
    'Screw': ['close_jar'],
    'Occulusion': ['open_drawer'],
})


def _number(cell: str) -> float:
    return float(cell) if cell.strip() else float("nan")


def read_csv(path: str) -> Dict[str, np.ndarray]:
    """Column name → float64 column (empty cells NaN)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return OrderedDict((name, np.array([_number(r[i]) for r in body],
                                       np.float64))
                       for i, name in enumerate(header))


def _returns(table: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The per-task return columns, named by their last '/' part."""
    return OrderedDict((c.split('/')[-1], v) for c, v in table.items()
                       if 'return' in c and 'mean_return' not in c)


def _row_mean(columns: List[np.ndarray], n: int) -> np.ndarray:
    if not columns:
        return np.full(n, np.nan)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # all-empty rows
        return np.nanmean(np.stack(columns, axis=1), axis=1)


def calculate_average_return(table: Dict[str, np.ndarray]) -> np.ndarray:
    return _row_mean(list(_returns(table).values()), len(table['step']))


def category_table(table: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """'step' and, for each category with a task in the file, the mean of
    its tasks' returns, row by row."""
    returns = _returns(table)
    out = OrderedDict(step=table['step'])
    for cat, tasks in CAT_GROUP_TO_TASK.items():
        cols = [returns[t] for t in tasks if t in returns]
        if cols:
            out[cat] = _row_mean(cols, len(table['step']))
    return out


def aggregate(file_paths: List[str], method: str = 'last'
              ) -> Tuple[float, float, Dict[str, float]]:
    """Returns (mean over seeds, std over seeds, per-seed selected returns)."""
    selected: Dict[str, float] = {}
    for path in file_paths:
        table = read_csv(path)
        avg = calculate_average_return(table)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            if method == 'best':
                val = float(np.nanmax(avg))
            elif method == 'last':
                val = float(avg[int(np.nanargmax(table['step']))])
            elif str(method).isdigit():
                val = float(avg[int(method)])
            else:
                raise ValueError(f'unknown method {method}')
        selected[path] = val
    vals = list(selected.values())
    return float(np.mean(vals)), float(np.std(vals)), selected


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--file_paths', nargs='+', required=True)
    parser.add_argument('--method', default='last')
    args = parser.parse_args(argv)
    mean, std, per_seed = aggregate(args.file_paths, args.method)
    for path, v in per_seed.items():
        print(f'{path}: {v:.2f}')
    print(f'Average return over all seeds: {mean:.2f}')
    print(f'Standard deviation over all seeds: {std:.2f}')


if __name__ == '__main__':
    main()
