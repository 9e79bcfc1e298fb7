"""Bootstrap calls (circuit levels, gates and MUXes, each one batched
bootstrap) a full-width authentication makes: the program's
`CipherBackend.launches` counter over the window's whole requests, divided
by their number."""

LAYER = "circuits"
UNIT = "calls"
MOVES = "auth_s"


def read(r):
    if not r.request_s or not r.bootstrap_calls:
        return None
    return r.bootstrap_calls / len(r.request_s)
