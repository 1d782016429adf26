"""Environment capability guards (round-2 verdict weak #8).

The capabilities that *gate* real coverage must be present, so a broken
toolchain fails the suite instead of silently skipping it hollow.
"""


def test_compile_cache_dir_is_fixed(monkeypatch):
    # the persistent compile cache keys on its path: it is the env var's
    # directory when set, else one fixed directory in the checkout
    import os

    import jax

    from kmers_tpu.utils.compile_cache import _ROOT, use_compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
        assert use_compile_cache() == "/elsewhere"
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        path = use_compile_cache()
        assert path == os.path.join(_ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert os.path.isdir(os.path.join(_ROOT, "kmers_tpu"))
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_native_scanner_available():
    from kmers_tpu.io import native_available

    assert native_available(), (
        "C++ FASTX scanner failed to build/load: native-path tests would "
        "silently skip (g++ is a baked-in dependency of this image)"
    )


def test_virtual_mesh_present():
    import jax

    assert len(jax.devices()) >= 8, (
        "tests require the 8-device virtual CPU mesh (conftest.py sets "
        "xla_force_host_platform_device_count=8)"
    )
