"""The whole window over the training steps completed in it."""


def read(run):
    return 1e3 * run.window_s / len(run.records)
