"""Environment-variable configuration layer (reference
doc/virtman.tex:4629ff): checkenvvaronoff semantics (kurtz-basic/
checkonoff.c: value must be "on" or "off"), MKVTREESMAPDIR symbol-map
search path (mkvprocess.c:523 scanpathsforfile), VMATCHSHOWTIMESPACE
(vmatch.mn.c:44-52,91-96), VMATCHRELATIVEINDEXPATH (procargs.c:61),
QUERYSPEEDUP (parsevm.c:466-483)."""

from __future__ import annotations

import os


def check_env_on_off(varname: str) -> bool:
    """checkenvvaronoff (checkonoff.c:20-39)."""
    v = os.environ.get(varname)
    if v is None:
        return False
    if v == "on":
        return True
    if v == "off":
        return False
    raise SystemExit(
        f'environment variable {varname} must set "on" or "off"')


def scan_paths_for_file(envvar: str, filename: str) -> str:
    """scanpathsforfile: the file itself, else each :-separated
    directory of the environment variable."""
    if os.path.exists(filename):
        return filename
    for p in os.environ.get(envvar, "").split(":"):
        if p:
            cand = os.path.join(p, filename)
            if os.path.exists(cand):
                return cand
    raise SystemExit(
        f'cannot find file "{filename}" (also searched ${envvar})')


def configure_compile_cache() -> str:
    """Point JAX's persistent compile cache at
    ``JAX_COMPILATION_CACHE_DIR`` as given when it is set, otherwise at
    ``.jax_cache/<backend>`` inside the checkout (a fixed path, so every
    run of the same checkout finds what earlier runs compiled); returns
    the directory."""
    # cache loads can emit C++-side glog chatter (e.g. the AOT
    # cpu-feature advisory) on stderr, which must stay byte-clean for
    # the reference-parity contract of the CLIs
    os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "3")
    import jax

    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        cache = os.path.join(root, ".jax_cache", jax.default_backend())
    os.makedirs(cache, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache
