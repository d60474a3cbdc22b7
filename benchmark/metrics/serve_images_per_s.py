"""Images whose outputs were complete on the card inside the window, over
the window's seconds."""


def read(run):
    return sum(i.images for i in run.window.done()) / run.seconds
