"""Key serialization with reference string-format parity.

The port's copy of ``cuhe_tpu/serialize.py``.  Re-implements Picklable / PicklableMap (cuhe/Utils.h:39-93, Utils.cu:29-224):
a Picklable is "key,coeff0,coeff1,..." (separator ","), a PicklableMap joins
pickles with "\\n".  Key bundles written by the reference's
CuDHS::getPublicKey/getPrivateKey (examples/DHS/DHS.cu:120-189) use the same
field inventory: d,p,w,min,cut,m, coeffMod, polyMod, pk<i>, ek<i>, [sk<i>].
"""

from __future__ import annotations


class Picklable:
    def __init__(self, key: str, coeffs: list[int], separator: str = ","):
        self.key = key
        self.coeffs = [int(c) for c in coeffs]
        self.separator = separator

    @classmethod
    def from_string(cls, data: str, separator: str = ",") -> "Picklable":
        parts = [p for p in data.split(separator) if p != ""]
        return cls(parts[0], [int(v) for v in parts[1:]], separator)

    def values_string(self) -> str:
        return self.separator.join(str(c) for c in self.coeffs)

    def pickle(self) -> str:
        return f"{self.key}{self.separator}{self.values_string()}"


class PicklableMap:
    def __init__(self, picklables: list[Picklable], separator: str = "\n"):
        self.picklables = picklables
        self.separator = separator

    @classmethod
    def from_string(cls, data: str, separator: str = "\n",
                    psep: str = ",") -> "PicklableMap":
        items = [Picklable.from_string(chunk, psep)
                 for chunk in data.split(separator) if chunk.strip() != ""]
        return cls(items, separator)

    def to_string(self) -> str:
        return self.separator.join(p.pickle() for p in self.picklables)

    def get(self, key: str) -> Picklable:
        for p in self.picklables:
            if p.key == key:
                return p
        raise KeyError(key)

    def has(self, key: str) -> bool:
        return any(p.key == key for p in self.picklables)
