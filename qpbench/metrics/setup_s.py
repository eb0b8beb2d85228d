"""Set-up: from the start of the process to the end of the warm-up."""


def read(run):
    return run.setup_s
