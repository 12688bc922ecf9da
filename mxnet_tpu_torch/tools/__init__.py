"""Command-line tools of the port (`python -m mxnet_tpu_torch.tools.<name>`).

The port's counterparts of the reference's operator tools under `tools/`:
`serve`, `aot_warm`, `chaos_serve`, `chaos_train`, `bandwidth`,
`diagnose`, `im2rec` and `rec2idx`. Each takes the reference parser's
flags plus `--device {cuda,cpu}`: the card by default (a machine without
one raises SystemExit naming it), the CPU when asked. The reference's
stdlib-only tools (`postmortem`, `fleet_top`, `train_top`, `launch`,
`rollout`, `train_supervise`, `kill_jobs`, `parse_log`,
`bench_sentinel`) drive the port as they are and stay shared."""


def add_device_flag(ap):
    """Add the port's `--device {cuda,cpu}` flag (default cuda)."""
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run on the card (default; a machine without one "
                         "raises) or on the CPU")


def require_device(name):
    """`name`, after a SystemExit naming the card when it is "cuda" and
    torch sees none: no tool falls back to the CPU on its own."""
    import torch
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch.cuda.is_available() is "
                         "False (no NVIDIA GPU visible); pass --device cpu "
                         "to run on the CPU")
    return name
