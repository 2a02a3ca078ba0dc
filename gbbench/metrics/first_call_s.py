"""first_call_s: the harness's ``first_call`` span in set-up (host clock, ended
by a device synchronize); the entry's module says what it covers."""


def read(ctx):
    return ctx["spans"].get("first_call")
