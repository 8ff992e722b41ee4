"""Label generation service: entity URIs -> symbology images.

Reference: service-label-generation —
  DefaultEntityUriProvider.java (sitewhere://<type>/<token> URIs),
  QrCodeGenerator.java (per-generator image config),
  LabelGeneratorManager.java (named generator registry, getLabelGenerator),
  grpc/LabelGenerationImpl.java (get*Label rpcs per entity type).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from sitewhere_tpu_torch.errors import ErrorCode, SiteWhereError
from sitewhere_tpu_torch.labels.png import write_png_gray
from sitewhere_tpu_torch.labels.qr import encode_qr, qr_matrix_to_image
from sitewhere_tpu_torch.runtime.lifecycle import LifecycleComponent

SITEWHERE_PROTOCOL = "sitewhere://"


class EntityUriProvider:
    """sitewhere:// URIs for every addressable entity type
    (DefaultEntityUriProvider.java)."""

    @staticmethod
    def uri(entity_type: str, token: str) -> str:
        return f"{SITEWHERE_PROTOCOL}{entity_type}/{token}"

    customer_type = staticmethod(lambda t: EntityUriProvider.uri("customertype", t))
    customer = staticmethod(lambda t: EntityUriProvider.uri("customer", t))
    area_type = staticmethod(lambda t: EntityUriProvider.uri("areatype", t))
    area = staticmethod(lambda t: EntityUriProvider.uri("area", t))
    device_type = staticmethod(lambda t: EntityUriProvider.uri("devicetype", t))
    device = staticmethod(lambda t: EntityUriProvider.uri("device", t))
    device_group = staticmethod(lambda t: EntityUriProvider.uri("devicegroup", t))
    assignment = staticmethod(lambda t: EntityUriProvider.uri("assignment", t))
    asset_type = staticmethod(lambda t: EntityUriProvider.uri("assettype", t))
    asset = staticmethod(lambda t: EntityUriProvider.uri("asset", t))


class QrCodeGenerator(LifecycleComponent):
    """QR symbology generator (QrCodeGenerator.java): configurable module
    scale, quiet zone, and EC level; produces PNG bytes."""

    def __init__(self, generator_id: str = "qrcode", name: str = "QR-Code",
                 scale: int = 8, border: int = 4, ec_level: str = "M"):
        super().__init__(f"label-generator:{generator_id}")
        self.id = generator_id
        self.generator_name = name
        self.scale = scale
        self.border = border
        self.ec_level = ec_level

    def generate(self, uri: str) -> bytes:
        matrix = encode_qr(uri.encode(), level=self.ec_level)
        return write_png_gray(qr_matrix_to_image(matrix, self.scale,
                                                 self.border))


class LabelGeneratorManager(LifecycleComponent):
    """Named registry of label generators (LabelGeneratorManager.java:
    getLabelGenerators/getLabelGenerator)."""

    def __init__(self, generators: Optional[List] = None):
        super().__init__("label-generator-manager")
        gens = generators if generators is not None else [QrCodeGenerator()]
        self._generators: Dict[str, object] = {}
        for g in gens:
            self._generators[g.id] = g
            self.add_nested(g)

    def generator_ids(self) -> List[str]:
        return list(self._generators)

    def get_generator(self, generator_id: str):
        gen = self._generators.get(generator_id)
        if gen is None:
            raise SiteWhereError(
                f"label generator '{generator_id}' not found",
                ErrorCode.GENERIC, http_status=404)
        return gen

    # -- entity label entry points (LabelGenerationImpl rpcs) ---------------

    def label_for(self, generator_id: str, entity_type: str,
                  token: str) -> bytes:
        uri = EntityUriProvider.uri(entity_type, token)
        return self.get_generator(generator_id).generate(uri)

    def device_label(self, generator_id: str, token: str) -> bytes:
        return self.label_for(generator_id, "device", token)

    def device_type_label(self, generator_id: str, token: str) -> bytes:
        return self.label_for(generator_id, "devicetype", token)

    def assignment_label(self, generator_id: str, token: str) -> bytes:
        return self.label_for(generator_id, "assignment", token)

    def area_label(self, generator_id: str, token: str) -> bytes:
        return self.label_for(generator_id, "area", token)

    def customer_label(self, generator_id: str, token: str) -> bytes:
        return self.label_for(generator_id, "customer", token)

    def asset_label(self, generator_id: str, token: str) -> bytes:
        return self.label_for(generator_id, "asset", token)
