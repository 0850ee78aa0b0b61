"""K3: the line search's scoring rollout (``csrc/sl_rollout.cuh``, the Score
policy): every candidate step of a block rolled out closed loop, its AL
objective accumulated.  A launch scores one block of candidates."""

from portbench.counts import rollout_launch

ROLE = "rollout"
SCORES = True       # a launch scores one block of candidates: launch(shape, nb)


def match(name: str) -> bool:
    return "sl_rollout_kernel" in name and "Score" in name


def launch(shape: dict, nb: int) -> tuple:
    return rollout_launch(shape, nb)
