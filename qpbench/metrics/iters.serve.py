"""Mean ADMM iterations per solve over the traced solves (the solutions'
own count)."""


def read(run):
    it = [r["iterations"] for r in run.records if "iterations" in r]
    return sum(it) / len(it) if it else None
