"""Mean over the requests admitted in the traced steps of the harness's
first-token time (the return of the step that admitted it) − the port's
``engine.first_token`` mark (the host holds the token), in ms: how long
a first token waits in the engine for its step to end."""
from perfbench import spans


def read(rec):
    return spans.first_token_hold_ms(rec)
