"""Time one spawn of ``chip_smoke.py`` phase 10d's (2, 2) jobs on the
card, rank by rank: when each rank reaches its first job (seconds after
its own start) and each job's span beside its set-up and wall.

A spawn whose ranks start one after another shows in the first times as
a staircase; ranks that start together reach their first job together.

    python tools/spawn_probe.py      # one H100; builds the kernels first
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
T0 = time.time()


def timed_each(rank, fn, jobs):
    """``mesh_jobs.each`` with each job's span printed."""
    out = []
    print(f"[rank {rank}] first job at +{time.time() - T0:.1f} s",
          flush=True)
    for i, job in enumerate(jobs):
        a = time.time()
        r = fn(rank, job)
        step = "decode" if job.decode else "prefill"
        print(f"[rank {rank}] job {i} {job.cfg.name} {step}: "
              f"{time.time() - a:.2f} s (setup {r['setup_s']:.2f}, wall "
              f"{r['wall_s']:.2f})", flush=True)
        out.append(r)
    return out


def main():
    import chip_smoke as cs
    from repro_torch.parallel import mesh_jobs as jobs
    cs.build_kernels()
    items = cs.tp_serve_jobs()[(2, 2)]
    t = time.time()
    cs._spawn(timed_each, 4, (jobs.serve_job, [j for _, j, _ in items]),
              900.0)
    print(f"spawn (2, 2) {time.time() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main()
