"""Set-up: from the process's start to the window's opening (loading the
corpus, building and warming the program, its warm-up chunks)."""


def read(run):
    return run.setup_s
