"""setup_s: process start to the window's start (host clock): the data
made from the seed, CUDA up, the program's state staged, every shape of
the cell warmed up."""


def read(run):
    return run.setup_s
