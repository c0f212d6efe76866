"""Per-dataset processing recipes (the reference's 35 processor subclasses).

Each entry supplies what a layout adapter cannot infer: the label-value ->
taxonomy-name map (or mask-file-stem map for per-class-file layouts), per-class
semantic flags (instances merged?), modality, and the layout adapter to use.
Class vocabularies follow the public dataset definitions, cross-checked
against the reference's processors (``scripts/data/local/processors/*.py``):
AMOS, MSD, KiTS, LiTS, VerSe, TotalSegmentator, BraTS, ACDC, ATM22, BTCV,
BUSI, CHAOS, CT-ORG, CTPelvic1K, CTSpine1K, HaN-Seg, LIDC-IDRI, MRSpineSeg,
PARSE2022, PENGWIN, Prostate158, RibFrac, SegRap2023, SegTHOR, PI-CAI,
ISLES22, ATLAS, SEG.A.2023, LNQ2023, autoPET-III, VinDr-CXR.

Usage: ``scripts/data/process.py --dataset AMOS22 --src ... --out ...``.

The port's own copy of ``mmmm_tpu/preprocess/registry.py``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DatasetRecipe:
    name: str
    layout: str  # nnunet | segfolder | boxfolder
    modality: str = "CT"
    class_map: dict[int, str] | None = None  # overrides dataset.json when set
    semantic: dict[str, bool] | None = None  # default: semantic (merged)
    instance_classes: tuple[str, ...] = ()  # classes to split into instances
    file_class_map: dict[str, str] | None = None  # segfolder: file stem -> name
    image_name: str = "ct.nii.gz"  # segfolder: image file per case


def _sem(recipe_classes: dict[int, str], instance: tuple[str, ...]) -> dict[str, bool]:
    return {name: name not in instance for name in recipe_classes.values()}


_AMOS_CLASSES = {
    1: "spleen", 2: "right kidney", 3: "left kidney", 4: "gallbladder",
    5: "esophagus", 6: "liver", 7: "stomach", 8: "aorta", 9: "inferior vena cava",
    10: "pancreas", 11: "right adrenal gland", 12: "left adrenal gland",
    13: "duodenum", 14: "urinary bladder", 15: "prostate",
}

_VERTEBRA_MAP = {
    **{i: f"C{i} vertebra" for i in range(1, 8)},
    **{i: f"T{i - 7} vertebra" for i in range(8, 20)},
    **{i: f"L{i - 19} vertebra" for i in range(20, 26)},
}

REGISTRY: dict[str, DatasetRecipe] = {}


def _register(r: DatasetRecipe):
    REGISTRY[r.name] = r
    return r


def _seg(name, modality, class_map, instance=(), **kw):
    return _register(DatasetRecipe(
        name, "nnunet", modality, class_map, _sem(class_map, instance),
        instance_classes=tuple(instance), **kw,
    ))


_seg("AMOS22", "CT", _AMOS_CLASSES)
_seg("KiTS23", "CT", {1: "kidney", 2: "kidney tumor", 3: "kidney cyst"},
     instance=("kidney tumor", "kidney cyst"))
_seg("LiTS17", "CT", {1: "liver", 2: "liver tumor"}, instance=("liver tumor",))
# Medical Segmentation Decathlon
_seg("MSD-Task01-BrainTumour", "MRI",
     {1: "peritumoral edema", 2: "non-enhancing tumor core", 3: "enhancing tumor"})
_seg("MSD-Task02-Heart", "MRI", {1: "left atrium"})
_seg("MSD-Task03-Liver", "CT", {1: "liver", 2: "liver tumor"}, instance=("liver tumor",))
_seg("MSD-Task04-Hippocampus", "MRI",
     {1: "anterior hippocampus", 2: "posterior hippocampus"})
_seg("MSD-Task05-Prostate", "MRI",
     {1: "peripheral zone of prostate", 2: "transition zone of prostate"})
_seg("MSD-Task06-Lung", "CT", {1: "lung tumor"}, instance=("lung tumor",))
_seg("MSD-Task07-Pancreas", "CT", {1: "pancreas", 2: "pancreatic tumor"},
     instance=("pancreatic tumor",))
_seg("MSD-Task08-HepaticVessel", "CT", {1: "hepatic vessel", 2: "liver tumor"},
     instance=("liver tumor",))
_seg("MSD-Task09-Spleen", "CT", {1: "spleen"})
_seg("MSD-Task10-Colon", "CT", {1: "colon cancer"}, instance=("colon cancer",))
# BraTS-style tumor-region masks (semantic) — all five 2023 tracks
# (ref BraTS2023.py:58-81: GLI/MEN/MET/PED/SSA share one processor; PED and
# SSA enabled in conf/align-sam/data.yaml:23-25)
for _suffix in ("GLI", "MEN", "MET", "PED", "SSA"):
    _seg(f"BraTS2023-{_suffix}", "MRI",
         {1: "necrotic tumor core", 2: "peritumoral edema", 3: "enhancing tumor"})
_register(DatasetRecipe("TotalSegmentator", "segfolder", "CT"))
_register(DatasetRecipe("VinDr-CXR", "boxfolder", "X-ray"))
_seg("VerSe", "CT", _VERTEBRA_MAP)
_seg("WORD", "CT", {
    1: "liver", 2: "spleen", 3: "left kidney", 4: "right kidney", 5: "stomach",
    6: "gallbladder", 7: "esophagus", 8: "pancreas", 9: "duodenum", 10: "colon",
    11: "intestine", 12: "right adrenal gland", 13: "rectum", 14: "urinary bladder",
    15: "left head of femur", 16: "right head of femur",
})
# cardiac cine-MRI (ref ACDC.py:19-60)
_seg("ACDC", "MRI",
     {1: "right ventricle cavity", 2: "myocardium", 3: "left ventricle cavity"})
# airway tree (ref ATM22.py:8-30)
_seg("ATM22", "CT", {1: "airway"})
# BTCV multi-organ (ref BTCV.py:30-62)
_seg("BTCV-Abdomen", "CT", {
    1: "spleen", 2: "right kidney", 3: "left kidney", 4: "gallbladder",
    5: "esophagus", 6: "liver", 7: "stomach", 8: "aorta", 9: "inferior vena cava",
    10: "portal vein and splenic vein", 11: "pancreas",
    12: "right adrenal gland", 13: "left adrenal gland",
})
_seg("BTCV-Cervix", "CT",
     {1: "urinary bladder", 2: "uterus", 3: "rectum", 4: "small intestine"})
# breast ultrasound, one binary tumor mask per case (ref BUSI.py:14-44)
_register(DatasetRecipe(
    "BUSI", "segfolder", "ultrasound",
    semantic={"breast cancer": False}, instance_classes=("breast cancer",),
    file_class_map={"mask": "breast cancer"}, image_name="image.png",
))
# CHAOS MR label values (ref CHAOS.py:37-44; the CT split is liver-only)
_seg("CHAOS", "MRI",
     {63: "liver", 126: "right kidney", 189: "left kidney", 252: "spleen"})
_seg("CT-ORG", "CT", {1: "liver", 2: "urinary bladder", 3: "lung", 4: "kidney"})
_seg("CTPelvic1K", "CT", {1: "sacrum", 2: "right hip bone", 3: "left hip bone"})
_seg("CTSpine1K", "CT", _VERTEBRA_MAP)
# head & neck OARs, one .seg.nrrd per class (ref HaNSeg.py:10-60)
_register(DatasetRecipe(
    "HaN-Seg", "segfolder", "CT",
    file_class_map={
        "A_Carotid_L": "left carotid artery", "A_Carotid_R": "right carotid artery",
        "Arytenoid": "arytenoid cartilages", "Bone_Mandible": "mandible",
        "Brainstem": "brainstem", "BuccalMucosa": "buccal mucosa",
        "Cavity_Oral": "oral cavity", "Cochlea_L": "left cochlea",
        "Cochlea_R": "right cochlea", "Cricopharyngeus": "cricopharyngeus",
        "Esophagus_S": "cervical esophagus",
        "Eye_AL": "anterior segment of left eyeball",
        "Eye_AR": "anterior segment of right eyeball",
        "Eye_PL": "posterior segment of left eyeball",
        "Eye_PR": "posterior segment of right eyeball",
        "Glnd_Lacrimal_L": "left lacrimal gland", "Glnd_Lacrimal_R": "right lacrimal gland",
        "Glnd_Submand_L": "left submandibular gland",
        "Glnd_Submand_R": "right submandibular gland",
        "Glnd_Thyroid": "thyroid", "Glottis": "glottis",
        "Larynx_SG": "supraglottis", "Lips": "lip",
    },
))
# lung nodules as instances (ref LIDC_IDRI.py:112-137 clusters annotations;
# taxonomy canonical name 'lung nodule', LIDC_IDRI.py:137)
_seg("LIDC-IDRI", "CT", {1: "lung nodule"}, instance=("lung nodule",))
_seg("MRSpineSeg", "MRI", {
    1: "sacrum", 2: "L5 vertebra", 3: "L4 vertebra", 4: "L3 vertebra",
    5: "L2 vertebra", 6: "L1 vertebra", 7: "T12 vertebra", 8: "T11 vertebra",
    9: "T10 vertebra", 10: "T9 vertebra",
    **{10 + i: f"{d} intervertebral disc" for i, d in enumerate(
        ["L5-S1", "L4-L5", "L3-L4", "L2-L3", "L1-L2", "T12-L1",
         "T11-T12", "T10-T11", "T9-T10"], start=1)},
})
_seg("PARSE2022", "CT", {1: "pulmonary artery"})
# PENGWIN T1: fragment labels 1-10 sacrum, 11-20 left hip, 21-30 right hip
_seg("PENGWIN-T1", "CT", {
    **{i: "sacrum" for i in range(1, 11)},
    **{i: "left hip bone" for i in range(11, 21)},
    **{i: "right hip bone" for i in range(21, 31)},
})
_seg("Prostate158", "MRI", {
    1: "transition zone of prostate", 2: "peripheral zone of prostate",
    3: "prostate cancer",
}, instance=("prostate cancer",))
# per-instance fracture labels; cap follows RibFrac's max fractures per scan
_seg("RibFrac", "CT", {i: "rib fracture" for i in range(1, 65)},
     instance=("rib fracture",))
# nasopharyngeal-carcinoma OARs, one file per class (ref SegRap2023.py:20-75;
# the reference merges left+right mandible into one class post-load)
_register(DatasetRecipe(
    "SegRap2023", "segfolder", "CT",
    file_class_map={
        "Brain": "brain", "BrainStem": "brainstem", "Chiasm": "optic chiasm",
        "TemporalLobe_L": "left temporal lobe", "TemporalLobe_R": "right temporal lobe",
        "Hippocampus_L": "left hippocampus", "Hippocampus_R": "right hippocampus",
        "Eye_L": "left eye", "Eye_R": "right eye",
        "Lens_L": "lens of left eye", "Lens_R": "lens of right eye",
        "OpticNerve_L": "left optic nerve", "OpticNerve_R": "right optic nerve",
        "MiddleEar_L": "left middle ear", "MiddleEar_R": "right middle ear",
        "IAC_L": "left internal auditory canal", "IAC_R": "right internal auditory canal",
        "TympanicCavity_L": "left tympanic cavity", "TympanicCavity_R": "right tympanic cavity",
        "VestibulSemi_L": "left semicircular canal", "VestibulSemi_R": "right semicircular canal",
        "Cochlea_L": "left cochlea", "Cochlea_R": "right cochlea",
        "ETbone_L": "left eustachian tube", "ETbone_R": "right eustachian tube",
        "Pituitary": "pituitary", "OralCavity": "oral cavity",
        "Mandible_L": "left mandible", "Mandible_R": "right mandible",
        "Submandibular_L": "left submandibular gland",
        "Submandibular_R": "right submandibular gland",
        "Parotid_L": "left parotid gland", "Parotid_R": "right parotid gland",
        "Mastoid_L": "left mastoid bone", "Mastoid_R": "right mastoid bone",
        "TMjoint_L": "left temporomandibular joint",
        "TMjoint_R": "right temporomandibular joint",
        "SpinalCord": "spinal cord", "Esophagus": "esophagus", "Larynx": "larynx",
        "Larynx_Glottic": "glottis", "Larynx_Supraglot": "supraglottis",
        "PharynxConst": "pharynx", "Thyroid": "thyroid", "Trachea": "trachea",
    },
))
_seg("SegTHOR", "CT", {1: "esophagus", 2: "heart", 3: "trachea", 4: "aorta"})
_seg("PI-CAI", "MRI", {1: "prostate cancer"}, instance=("prostate cancer",))
_seg("ISLES22", "MRI", {1: "stroke lesion"}, instance=("stroke lesion",))
_seg("ATLAS", "MRI", {1: "stroke lesion"}, instance=("stroke lesion",))
_seg("SEG.A.2023", "CT", {1: "aortic vessel tree"})
_seg("LNQ2023", "CT", {1: "mediastinal lymph node"})
_seg("autoPET-III", "CT", {1: "tumor"}, instance=("tumor",))


def build_processor(name: str, src, out, conf=None):
    from .boxes import BoxFolderProcessor
    from .processor import NNUNetProcessor
    from .seg_folder import SegFolderProcessor

    recipe = REGISTRY[name]
    if recipe.layout == "nnunet":
        proc = NNUNetProcessor(src, out, name=name, modality=recipe.modality,
                               semantic=recipe.semantic, conf=conf)
        if recipe.class_map is not None:
            base_get = proc.get_cases

            def get_cases():
                cases = base_get()
                for c in cases:
                    c.class_map = recipe.class_map
                return cases

            proc.get_cases = get_cases
        return proc
    if recipe.layout == "segfolder":
        return SegFolderProcessor(
            src, out, name=name, modality=recipe.modality,
            image_name=recipe.image_name if recipe.file_class_map else "ct.nii.gz",
            class_name_map=recipe.file_class_map, conf=conf,
        )
    if recipe.layout == "boxfolder":
        from .boxes import load_box_cases

        return BoxFolderProcessor(name, load_box_cases(src), out, conf=conf)
    raise ValueError(f"{name}: layout {recipe.layout} needs a processor of its own")
