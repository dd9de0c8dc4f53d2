"""The share of the profiled sub-window in which no operation ran on the
device (the device operations' intervals merged)."""


def read(run):
    return 100.0 * run["trace"].idle_share()
