"""Root pytest hooks.

``text2nerf_tpu/native/libhost_ops.so`` is tracked, and ``load()`` rebuilds
it in place (``g++ -o libhost_ops.so``) whenever it is older than
``host_ops.cpp``, as a fresh checkout may leave it. Under pytest-xdist every
worker that loads the library would then rebuild it at once, and a worker
can ``dlopen`` the file while another worker's linker is rewriting it
("file too short"); that worker caches the error and its hole-fill tests
fail. The controller builds and loads the library once here, before it
starts any worker, so the workers find it fresh and none rebuilds it.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):  # an xdist worker
        return
    from text2nerf_tpu import native

    native.load()
