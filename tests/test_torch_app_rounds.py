"""tools/app_rounds.py on the CPU at a tiny size: two rounds of the port's
application from this checkout on a 12-frame 160x120 synthetic dataset,
one JSON line a run and the summary's means from the app's timing
report."""

import json

from surfelmeshing_tpu_torch.tools import app_rounds


def test_app_rounds_reports_each_run(capsys):
    runs = app_rounds.main([
        "--frames", "12", "--width", "160", "--height", "120",
        "--rounds", "2", ".", "--", "--device", "cpu",
        "--max_surfel_count", "40000", "--outlier_filtering_frame_count",
        "2"])
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert [r["round"] for r in runs] == [0, 1]
    assert lines[:2] == runs
    for run in runs:
        count, ms = run["tags"]["integration"]
        assert count > 0 and ms > 0 and run["wall_s"] > 0
    summary = lines[-1]["summary"]["."]
    assert summary["integration_ms"] == sum(
        r["tags"]["integration"][1] for r in runs) / 2
