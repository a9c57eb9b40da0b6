"""prefill_step_ms: the model step on prompts.  Over the window's prefill
ticks (``benchkit.spans.ticks``), the summed ``serve.device`` spans (the
first dispatch to the end of the tick's host copy) over the summed
positions ``L`` they ran: the time of one step of the tick's rows, in
ms."""
from benchkit import spans


def read(run, device="cuda"):
    return spans.step_ms(run, lambda mode: mode == "prefill", device)
