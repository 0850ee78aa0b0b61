"""K4: the line search's winner re-roll (``csrc/sl_rollout.cuh``, the Reroll
policy): each lane's accepted step rolled out again, its trajectory,
constraint values and objective written."""

from portbench.counts import rollout_launch

ROLE = "rollout"


def match(name: str) -> bool:
    return "sl_rollout_kernel" in name and "Reroll" in name


def launch(shape: dict) -> tuple:
    return rollout_launch(shape)
