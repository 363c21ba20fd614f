"""File clients (counterpart of data/file_client.py): disk, packed
(OGIPack), lmdb and memcached storage behind one `get(key) -> bytes`. The
lmdb and memcached backends import their client packages when built, and
raise ImportError naming them where they are not installed."""

from ..runtime.packio import PackReader


class DiskBackend:
    def get(self, filepath):
        with open(filepath, "rb") as f:
            return f.read()


class PackedBackend:
    """OGIPack-backed storage; keys are the packed names (or indices)."""

    def __init__(self, db_path):
        self.reader = PackReader(db_path)
        self._by_name = {self.reader.name(i): i for i in range(len(self.reader))}

    def keys(self):
        return list(self._by_name)

    def get(self, key):
        if isinstance(key, int):
            return self.reader.read(key)
        return self.reader.read(self._by_name[key])


class LmdbBackend:
    def __init__(self, db_path, **kwargs):
        try:
            import lmdb
        except ImportError as e:
            raise ImportError("the lmdb backend needs the lmdb package") from e
        self.env = lmdb.open(db_path, readonly=True, lock=False, readahead=False, **kwargs)

    def get(self, key):
        with self.env.begin(write=False) as txn:
            return txn.get(key.encode("ascii"))


class MemcachedBackend:
    """Memcached-backed storage: keys are file paths served by a pre-loaded
    memcached cluster through its `mc` client library. No shipped config
    uses it."""

    def __init__(self, server_list_cfg, client_cfg, sys_path=None):
        if sys_path is not None:
            import sys
            sys.path.append(sys_path)
        try:
            import mc
        except ImportError as e:
            raise ImportError("the memcached backend needs the `mc` client library") from e
        self._mc = mc
        self._client = mc.MemcachedClient.GetInstance(server_list_cfg, client_cfg)
        self._mc_buffer = mc.pyvector()

    def get(self, filepath):
        self._client.Get(filepath, self._mc_buffer)
        return self._mc.ConvertBuffer(self._mc_buffer)


class FileClient:
    BACKENDS = {"disk": DiskBackend, "packed": PackedBackend,
                "lmdb": LmdbBackend, "memcached": MemcachedBackend}

    def __init__(self, backend="disk", **kwargs):
        if backend not in self.BACKENDS:
            raise ValueError(f"backend {backend} not in {list(self.BACKENDS)}")
        self.backend = self.BACKENDS[backend](**kwargs)

    def get(self, key):
        return self.backend.get(key)
