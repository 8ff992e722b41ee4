"""Label generation (QR symbology) — service-label-generation rebuilt."""

from sitewhere_tpu_torch.labels.manager import (
    EntityUriProvider, LabelGeneratorManager, QrCodeGenerator,
    SITEWHERE_PROTOCOL)
from sitewhere_tpu_torch.labels.png import read_png_gray, write_png_gray
from sitewhere_tpu_torch.labels.qr import (
    data_capacity, encode_qr, pick_version, qr_matrix_to_image, rs_ecc)

__all__ = [
    "EntityUriProvider", "LabelGeneratorManager", "QrCodeGenerator",
    "SITEWHERE_PROTOCOL", "read_png_gray", "write_png_gray",
    "data_capacity", "encode_qr", "pick_version", "qr_matrix_to_image",
    "rs_ecc",
]
