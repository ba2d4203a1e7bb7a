"""recall_at_10: over every distinct query the window sent, the share of
the reference's exact top 10 (over every row) that the answer holds."""


def read(run):
    return run.recall
