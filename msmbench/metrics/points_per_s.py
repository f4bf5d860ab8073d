"""points_per_s: n times the MSMs completed in the window, over the
window's seconds (host clock; the window ends when its last call's point
is on the host)."""


def read(rec):
    if not rec.window_s:
        return None
    return rec.n * rec.completed / rec.window_s
