"""Where the persistent compilation cache lands: the directory named by
JAX_COMPILATION_CACHE_DIR when it is set, else <checkout>/.jax_cache."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

PROBE = """
import sys, jax, jax.numpy as jnp
sys.path.insert(0, {repo!r})
from monica_tpu.utils import jaxcache
d = jaxcache.enable_compilation_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: jnp.sin(x) * 3)(jnp.arange(7.0)).block_until_ready()
print(d)
print(jax.config.jax_compilation_cache_dir)
"""


def _probe(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run([sys.executable, "-c", PROBE.format(repo=str(REPO))], env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    return out.stdout.split()


def test_cache_uses_the_environment_variable(tmp_path):
    target = tmp_path / "cache"
    returned, configured = _probe(target)
    assert Path(returned) == target and Path(configured) == target
    assert any(target.iterdir()), "no compiled program was written to the cache"


def test_cache_defaults_to_the_checkout_and_is_ignored():
    from monica_tpu.utils import jaxcache

    returned, configured = _probe(None)
    assert Path(returned) == jaxcache.CHECKOUT_CACHE == REPO / ".jax_cache"
    assert Path(configured) == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
