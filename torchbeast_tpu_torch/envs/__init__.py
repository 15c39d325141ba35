"""Environment construction (counterpart of torchbeast_tpu/envs/__init__.py).

`create_env(name, ...)` builds the dependency-free envs: "Mock" and
"Counting" (test envs), "Catch" and "Memory"/"Memory-L<n>" (learnable
tasks). The gymnasium Atari stack and MiniAtari are not in the port yet.
"""

from torchbeast_tpu_torch.envs.environment import Environment  # noqa: F401
from torchbeast_tpu_torch.envs.mock import (  # noqa: F401
    CatchEnv,
    CountingEnv,
    MemoryChainEnv,
    MockEnv,
    parse_memory_id,
)


def num_actions_of(env) -> int:
    """Discrete action count of a raw env (`num_actions` attribute, or a
    gym(nasium) `action_space.n`)."""
    if hasattr(env, "num_actions"):
        return int(env.num_actions)
    return int(env.action_space.n)


def create_env(name: str, seed=None, **kwargs):
    """`seed=None` draws OS entropy per stochastic env instance; a seed
    makes its draw stream deterministic (the driver passes env_seed + i)."""
    if name == "Mock":
        return MockEnv(**kwargs)
    if name == "Counting":
        return CountingEnv(**kwargs)
    if name == "Catch":
        return CatchEnv(seed=seed, **kwargs)
    memory_length = parse_memory_id(name)
    if memory_length is not None:
        return MemoryChainEnv(length=memory_length, seed=seed, **kwargs)
    raise NotImplementedError(
        f"--env {name!r}: the port has Mock, Counting, Catch and Memory; "
        "the Atari and MiniAtari envs come with ROADMAP.md Queue 1 item "
        "'Atari envs and the mlp model'"
    )
