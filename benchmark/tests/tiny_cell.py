"""A cell of BENCHMARK.json at a size a CPU test can hold: 160x120
frames, a map of 40,960 rows (163,840 with tiling), short periods and
warm-ups; the explore walk on a circuit and in a room scaled down so
that consecutive frames overlap as they do at full size."""

import time

from benchmark import cell as C

CAMERA = {"width": 160, "height": 120, "fx": 131.25, "fy": 131.25,
          "cx": 80.5, "cy": 60.5, "fps": 30}


def overrides(workload: str) -> dict:
    _, config, traffic = C.find_cell(workload)
    s = dict(config["settings"])
    cap = 163_840 if s["active_surfel_budget"] else 40_960
    s.update(max_surfel_count=cap, shape_bucket_step=4096,
             max_creations_per_frame=4096)
    traj = dict(traffic["trajectory"], period=12)
    scene = traffic["scene"]
    if traj["kind"] == "circuit":
        traj.update(radii=[0.12, 0.07], period=120)
        scene = dict(scene, planes=[dict(p) for p in scene["planes"]])
        for p in scene["planes"]:
            if p["axis"] == 0:
                p["value"] = 2.0 * p["sign"]
            if p["axis"] == 2:
                p["value"] = 1.8 * p["sign"]
    return {"config.camera": CAMERA, "config.settings": s,
            "traffic.trajectory": traj, "traffic.scene": scene,
            "traffic.warmup_frames": 8, "traffic.check_frames": 4,
            "traffic.trace_seconds": 1.0}


def run(workload: str, seed: int = 7, seconds: float = 1.0,
        control: bool = False, trace: bool = False):
    """(Run, its execute() result) of a tiny cell on the CPU."""
    r = C.Run(workload, seed, seconds, trace, time.perf_counter(),
              device="cpu", overrides=overrides(workload), control=control)
    return r, r.execute()
