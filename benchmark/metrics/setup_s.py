"""Set-up: from the process's start to the window's opening (host clock): building the kernels on a checkout's first run, making the seeded weights and frames, loading and warming the engine (capturing its steps), and the cameras' ramp."""

UNIT = "s"


def read(run):
    return run.setup_s
