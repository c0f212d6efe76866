"""Target taxonomy: class names, categories, synonyms, hierarchy.

Equivalent of ``mmmm/data/target_tax.py`` (which reads
``data/target-tax.xlsx`` with anatomy/anomaly sheets). This implementation
reads a JSON taxonomy (one object per class) and also accepts the reference's
xlsx when pandas+openpyxl can read it. A built-in mini taxonomy backs tests.

The port's own copy of ``mmmm_tpu/data/target_tax.py``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
from pathlib import Path

ANATOMY = "anatomy"
ANOMALY = "anomaly"


@dataclasses.dataclass
class TargetClass:
    name: str
    category: str  # anatomy | anomaly
    synonyms: list[str] = dataclasses.field(default_factory=list)
    parents: list[str] = dataclasses.field(default_factory=list)
    children: list[str] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.name not in self.synonyms:
            self.synonyms = [self.name, *self.synonyms]


_VERTEBRAE = ["C1", "C2", "C3", "C4", "C5", "C6", "C7",
              "T1", "T2", "T3", "T4", "T5", "T6", "T7", "T8", "T9", "T10", "T11", "T12",
              "L1", "L2", "L3", "L4", "L5", "L6"]
_DISCS = ["L5-S1", "L4-L5", "L3-L4", "L2-L3", "L1-L2", "T12-L1",
          "T11-T12", "T10-T11", "T9-T10"]
_RIBS = [f"{side} rib {i}" for side in ("left", "right") for i in range(1, 13)]


def _lr(name: str, category: str, synonyms: list[str] | None = None):
    """left/right pair + the unsided parent class."""
    out = [TargetClass(name, category, list(synonyms or []))]
    for side in ("left", "right"):
        out.append(TargetClass(f"{side} {name}", category, parents=[name]))
    return out


_BUILTIN = [
    # ---- anatomy: thorax / abdomen / pelvis (AMOS, BTCV, WORD, TotalSegmentator...)
    TargetClass("liver", ANATOMY, ["hepar"]),
    TargetClass("heart", ANATOMY, ["cardiac silhouette"]),
    *_lr("lung", ANATOMY),
    *_lr("kidney", ANATOMY, ["renal organ"]),
    TargetClass("spleen", ANATOMY),
    TargetClass("gallbladder", ANATOMY),
    TargetClass("esophagus", ANATOMY),
    TargetClass("cervical esophagus", ANATOMY, parents=["esophagus"]),
    TargetClass("stomach", ANATOMY),
    TargetClass("aorta", ANATOMY),
    TargetClass("aortic vessel tree", ANATOMY, parents=["aorta"]),
    TargetClass("inferior vena cava", ANATOMY, ["IVC"]),
    TargetClass("portal vein and splenic vein", ANATOMY, ["portal and splenic veins"]),
    TargetClass("pulmonary artery", ANATOMY),
    TargetClass("pancreas", ANATOMY),
    *_lr("adrenal gland", ANATOMY, ["suprarenal gland"]),
    TargetClass("duodenum", ANATOMY),
    TargetClass("urinary bladder", ANATOMY, ["bladder"]),
    TargetClass("prostate", ANATOMY),
    TargetClass("uterus", ANATOMY),
    TargetClass("colon", ANATOMY, ["large intestine", "large bowel"]),
    TargetClass("intestine", ANATOMY, ["bowel"]),
    TargetClass("small intestine", ANATOMY, ["small bowel"], parents=["intestine"]),
    TargetClass("rectum", ANATOMY),
    TargetClass("trachea", ANATOMY),
    TargetClass("airway", ANATOMY, ["airway tree", "bronchial tree"]),
    TargetClass("mediastinal lymph node", ANATOMY, ["mediastinal lymph nodes"]),
    TargetClass("breast", ANATOMY),
    # cardiac (ACDC, MSD-Heart)
    TargetClass("left atrium", ANATOMY),
    TargetClass("right atrium", ANATOMY),
    TargetClass("left ventricle cavity", ANATOMY, ["left ventricle", "left ventricular cavity"]),
    TargetClass("right ventricle cavity", ANATOMY, ["right ventricle", "right ventricular cavity"]),
    TargetClass("myocardium", ANATOMY, ["left ventricular myocardium"]),
    TargetClass("pericardium", ANATOMY),
    # vessels / misc
    TargetClass("hepatic vessel", ANATOMY, ["hepatic vessels"]),
    *_lr("carotid artery", ANATOMY),
    # prostate sub-anatomy (MSD-Prostate, Prostate158)
    TargetClass("peripheral zone of prostate", ANATOMY, parents=["prostate"]),
    TargetClass("transition zone of prostate", ANATOMY, ["central gland"], parents=["prostate"]),
    # brain / head & neck (HaN-Seg, SegRap2023, MSD-Hippocampus)
    TargetClass("brain", ANATOMY),
    TargetClass("brainstem", ANATOMY, ["brain stem"]),
    TargetClass("pituitary", ANATOMY, ["pituitary gland", "hypophysis"]),
    TargetClass("optic chiasm", ANATOMY, ["chiasm"]),
    *_lr("optic nerve", ANATOMY),
    *_lr("temporal lobe", ANATOMY),
    *_lr("hippocampus", ANATOMY),
    TargetClass("anterior hippocampus", ANATOMY, parents=["hippocampus"]),
    TargetClass("posterior hippocampus", ANATOMY, parents=["hippocampus"]),
    *_lr("eye", ANATOMY, ["eyeball"]),
    TargetClass("anterior segment of left eyeball", ANATOMY, parents=["left eye"]),
    TargetClass("anterior segment of right eyeball", ANATOMY, parents=["right eye"]),
    TargetClass("posterior segment of left eyeball", ANATOMY, parents=["left eye"]),
    TargetClass("posterior segment of right eyeball", ANATOMY, parents=["right eye"]),
    TargetClass("lens of left eye", ANATOMY, parents=["left eye"]),
    TargetClass("lens of right eye", ANATOMY, parents=["right eye"]),
    *_lr("lacrimal gland", ANATOMY),
    *_lr("cochlea", ANATOMY),
    *_lr("middle ear", ANATOMY),
    *_lr("internal auditory canal", ANATOMY, ["IAC"]),
    *_lr("tympanic cavity", ANATOMY),
    *_lr("semicircular canal", ANATOMY, ["vestibular semicircular canals"]),
    *_lr("eustachian tube", ANATOMY),
    *_lr("mastoid bone", ANATOMY, ["mastoid"]),
    *_lr("temporomandibular joint", ANATOMY, ["TMJ"]),
    *_lr("parotid gland", ANATOMY),
    *_lr("submandibular gland", ANATOMY),
    TargetClass("thyroid", ANATOMY, ["thyroid gland"]),
    TargetClass("mandible", ANATOMY),
    TargetClass("left mandible", ANATOMY, parents=["mandible"]),
    TargetClass("right mandible", ANATOMY, parents=["mandible"]),
    TargetClass("oral cavity", ANATOMY),
    TargetClass("buccal mucosa", ANATOMY),
    TargetClass("lip", ANATOMY, ["lips"]),
    TargetClass("arytenoid cartilages", ANATOMY, ["arytenoids"]),
    TargetClass("cricopharyngeus", ANATOMY, ["cricopharyngeal inlet"]),
    TargetClass("larynx", ANATOMY),
    TargetClass("glottis", ANATOMY, ["glottic larynx"], parents=["larynx"]),
    TargetClass("supraglottis", ANATOMY, ["supraglottic larynx"], parents=["larynx"]),
    TargetClass("pharynx", ANATOMY, ["pharynx constrictor muscles"]),
    TargetClass("spinal cord", ANATOMY),
    # skeleton (VerSe, CTSpine1K, CTPelvic1K, PENGWIN, MRSpineSeg)
    TargetClass("sacrum", ANATOMY),
    *_lr("hip bone", ANATOMY, ["pelvic bone", "innominate bone"]),
    *_lr("head of femur", ANATOMY, ["femoral head"]),
    *[TargetClass(f"{v} vertebra", ANATOMY, [f"vertebra {v}"]) for v in _VERTEBRAE],
    *[TargetClass(f"{d} intervertebral disc", ANATOMY) for d in _DISCS],
    *[TargetClass(r, ANATOMY) for r in _RIBS],
    *_lr("clavicle", ANATOMY, ["collarbone"]),
    *_lr("scapula", ANATOMY, ["shoulder blade"]),
    *_lr("humerus", ANATOMY),
    *_lr("femur", ANATOMY),
    TargetClass("sternum", ANATOMY, ["breastbone"]),
    # ---- anomaly
    TargetClass("glioma", ANOMALY, ["brain tumor"]),
    TargetClass("meningioma", ANOMALY),
    TargetClass("brain metastasis", ANOMALY, ["brain metastases"]),
    TargetClass("lung nodule", ANOMALY, ["nodule", "pulmonary nodule", "lung mass"]),
    TargetClass("pleural effusion", ANOMALY, ["effusion"]),
    TargetClass("pericardial effusion", ANOMALY),
    TargetClass("cardiomegaly", ANOMALY, ["enlarged heart", "enlarged cardiac silhouette"]),
    TargetClass("kidney tumor", ANOMALY, ["renal tumor"]),
    TargetClass("kidney cyst", ANOMALY, ["renal cyst"]),
    TargetClass("liver tumor", ANOMALY, ["hepatic tumor"]),
    TargetClass("lung tumor", ANOMALY),
    TargetClass("pancreatic tumor", ANOMALY, ["pancreatic cancer"]),
    TargetClass("colon cancer", ANOMALY, ["colorectal cancer"]),
    TargetClass("prostate cancer", ANOMALY, ["prostate carcinoma"]),
    TargetClass("breast cancer", ANOMALY, ["breast tumor"]),
    TargetClass("stroke lesion", ANOMALY, ["infarct lesion", "ischemic stroke lesion"]),
    TargetClass("tumor", ANOMALY, ["neoplasm", "lesion"]),
    TargetClass("necrotic tumor core", ANOMALY),
    TargetClass("peritumoral edema", ANOMALY),
    TargetClass("enhancing tumor", ANOMALY),
    TargetClass("non-enhancing tumor core", ANOMALY),
    TargetClass("atelectasis", ANOMALY, ["collapsed lung tissue"]),
    TargetClass("pneumothorax", ANOMALY),
    TargetClass("pneumonia", ANOMALY),
    TargetClass("pulmonary emphysema", ANOMALY, ["emphysema"]),
    TargetClass("pulmonary consolidation", ANOMALY, ["consolidation"]),
    TargetClass("pulmonary edema", ANOMALY, ["edema"]),
    TargetClass("pulmonary fibrosis", ANOMALY, ["fibrosis", "pulmonary fibrotic sequela"]),
    TargetClass("aortic enlargement", ANOMALY, ["dilated aorta"]),
    TargetClass("calcification", ANOMALY),
    TargetClass("arterial wall calcification", ANOMALY, parents=["calcification"]),
    TargetClass("coronary artery wall calcification", ANOMALY, parents=["calcification"]),
    TargetClass("interstitial lung disease", ANOMALY, ["ILD"]),
    TargetClass("pulmonary opacification", ANOMALY, ["lung opacity", "opacity"]),
    TargetClass("pleural thickening", ANOMALY),
    TargetClass("rib fracture", ANOMALY),
    TargetClass("clavicle fracture", ANOMALY),
    TargetClass("bone fracture", ANOMALY, ["fracture"]),
    TargetClass("mediastinal shift", ANOMALY),
    TargetClass("enlarged cardiomediastinum", ANOMALY, ["widened mediastinum"]),
    TargetClass("lymphadenopathy", ANOMALY, ["enlarged lymph node"]),
    TargetClass("hiatal hernia", ANOMALY, ["hiatus hernia"]),
    TargetClass("bronchiectasis", ANOMALY),
    TargetClass("mosaic attenuation pattern", ANOMALY),
    TargetClass("peribronchial thickening", ANOMALY, ["peribronchial wall thickening"]),
    TargetClass("interlobular septal thickening", ANOMALY, ["septal thickening"]),
    TargetClass("pulmonary infiltrate", ANOMALY, ["infiltration", "infiltrate"]),
    TargetClass("pulmonary cavity", ANOMALY, ["lung cavity", "cavitation"]),
    TargetClass("pulmonary cyst", ANOMALY, ["lung cyst"]),
    TargetClass("pulmonary artery enlargement", ANOMALY, ["enlarged pulmonary artery", "enlarged PA"]),
    TargetClass("support device", ANOMALY, ["medical device", "medical material"]),
]


def _index(classes) -> dict[str, TargetClass]:
    """Name -> class mapping that ALSO resolves synonyms (canonical names
    win on clashes), so dataset class maps, tagger targets and detector
    outputs join the taxonomy under any of a class's names."""
    idx = {t.name: t for t in classes}
    for t in classes:
        for s in t.synonyms:
            idx.setdefault(s, t)
    return idx


def load_target_tax(path: str | Path | None = None) -> dict[str, TargetClass]:
    if path is None:
        return _index(_BUILTIN)
    path = Path(path)
    if path.suffix == ".json":
        items = json.loads(path.read_text())
        return _index([
            TargetClass(
                d["name"],
                d["category"],
                d.get("synonyms", []),
                d.get("parents", []),
                d.get("children", []),
            )
            for d in items
        ])
    if path.suffix == ".xlsx":
        import pandas as pd

        classes = []
        for category in (ANATOMY, ANOMALY):
            df = pd.read_excel(path, sheet_name=category)
            for _, row in df.iterrows():
                syn = row.get("synonyms")
                synonyms = [s.strip() for s in str(syn).split("|")] if isinstance(syn, str) else []
                classes.append(TargetClass(row["name"], category, synonyms))
        return _index(classes)
    raise ValueError(f"unsupported taxonomy file {path}")


@functools.lru_cache(maxsize=4)
def get_target_tax(path: str | None = None) -> dict[str, TargetClass]:
    return load_target_tax(path)
