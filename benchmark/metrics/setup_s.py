"""Set-up: from the start of the process to the first timed batch (import,
CUDA context, weights, program, kernel load or build, input pool,
warm-up), less the seconds of the reference's own work in it (seg's
calibration of one bias)."""


def read(run):
    return run.setup_s
