"""registration_ms.experiment (ms): device ms of one replayed registration
solve (``register_sequence`` on the cell's poses), by CUDA events over
several replays."""


def read(run):
    d = run.driver
    if d.entry != "experiment":
        return None
    da, db, ang = d.inputs(0)
    batch = d.step()(da, db)
    pipeline = d.p.pipeline
    return run.cuda_ms(lambda: pipeline.register_sequence(batch, ang, d.reg_cfg), d.traffic["event_reps"])
