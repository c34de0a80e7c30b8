"""Mean band fraction of the window's incremental rounds: the change of
`skiing.total_incremental` (the widths of every view's band over n·k, a
round) over the rounds that did not reorganize."""


def read(rec):
    c = rec["counters"]
    rounds = rec["commits"] - c["reorgs"]
    return c["total_incremental"] / rounds if rounds > 0 else None
