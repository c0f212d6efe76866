"""Offline dataset processing (host code, no device work), the port's own
copy of ``mmmm_tpu/preprocess/``: NIfTI and DICOM readers, the processor
framework and its dataset adapters, box fusion, the dataset registry,
report sectioning and phrase tagging. The ``process`` command of
``cli.py`` drives it."""
from .nifti import read_nifti, write_nifti, NiftiImage
from .processor import Processor, ProcessorConfig, CaseSpec

__all__ = [
    "read_nifti",
    "write_nifti",
    "NiftiImage",
    "Processor",
    "ProcessorConfig",
    "CaseSpec",
]
