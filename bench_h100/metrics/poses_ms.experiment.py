"""poses_ms.experiment (ms): device ms of one replay of the experiment's
F-frame batch step (``compiled_batch`` on the cell's frames), by CUDA
events over several replays."""


def read(run):
    d = run.driver
    if d.entry != "experiment":
        return None
    da, db, _ = d.inputs(0)
    step = d.step()
    return run.cuda_ms(lambda: step(da, db), d.traffic["event_reps"])
