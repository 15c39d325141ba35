"""Environment construction (counterpart of torchbeast_tpu/envs/__init__.py).

`create_env(name, ...)` builds the dependency-free envs: "Mock" and
"Counting" (test envs), "Catch" and "Memory"/"Memory-L<n>" (learnable
tasks). Any other id goes to the gymnasium Atari stack
(envs/atari.create_atari_env): "tbt/MiniAtari-v0", the dependency-free
cabinet, or a real Atari id, which needs ale_py. gymnasium is imported
on that branch only.
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
    from torchbeast_tpu_torch.envs.atari import create_atari_env

    return create_atari_env(name, seed=seed, **kwargs)
