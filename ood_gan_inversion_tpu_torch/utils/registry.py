"""String-keyed registries (counterpart of utils/registry.py): the YAML
`type:` keys of datasets and metrics name the classes and functions
registered here."""


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._map = {}

    def register(self, obj=None, *, name: str | None = None):
        if obj is None:
            return lambda o: self.register(o, name=name)
        key = name or obj.__name__
        if key in self._map:
            raise KeyError(f"{key!r} already registered in {self._name}")
        self._map[key] = obj
        return obj

    def get(self, name: str):
        if name not in self._map:
            raise KeyError(
                f"{name!r} not found in registry {self._name}; "
                f"known: {sorted(self._map)}")
        return self._map[name]


METRIC_REGISTRY = Registry("metric")
DATASET_REGISTRY = Registry("dataset")
