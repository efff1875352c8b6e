"""The measured window: jobs back to back, ending on a job boundary."""

import time


def run_window(job, seconds, keep, clock=time.perf_counter):
    """Run ``job(k)`` for k = 0, 1, ... from the window's start until
    ``seconds`` have passed, finish the job in flight and stop the clock at
    its end.  ``keep(k, result)`` takes what the check keeps of each job's
    result before the next starts (the last job's after the clock stops).
    Returns ``(wall seconds, job walls)``."""
    t0 = clock()
    walls = []
    k = 0
    while True:
        start = clock()
        result = job(k)
        end = clock()
        walls.append(end - start)
        keep(k, result)
        del result  # the next job starts with this one's PCM freed
        if end - t0 >= seconds:
            return end - t0, walls
        k += 1

