"""decode_step_ms: the model step on generated tokens.  As
``prefill_step_ms`` over the window's decode and speculative ticks."""
from benchkit import spans


def read(run, device="cuda"):
    return spans.step_ms(run, lambda mode: mode != "prefill", device)
