"""Share of the window in the program's ``batch.plan`` span: the lapping
plans of each chunk's packets (``plan_job_arr``) and the per-job
bookkeeping, inside ``batch.collect`` on the main thread."""


def read(ctx):
    s = ctx["spans"].get("batch.plan")
    return None if s is None else 100.0 * s / ctx["window_s"]
