"""Entry points of the port: the training CLI (``launch.train``), the dry
run (``launch.dryrun``) and the production mesh (``launch.mesh``)."""


def device(name: str):
    """An entry point's ``--device`` as a ``torch.device``.  The port runs
    on the card by default; on a machine without one this exits with a
    message that names ``--device cpu``, in place of a torch error from
    deep inside the first allocation."""
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"no CUDA device for --device {name}: pass "
                         f"--device cpu to run on the CPU")
    return dev
