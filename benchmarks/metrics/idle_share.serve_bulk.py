"""The device's idle share of the traced window: 1 - the union of every
device operation's interval over the window."""

from benchmarks.harness.readers import idle_share


def read(rec):
    return idle_share(rec)
