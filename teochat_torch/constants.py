"""Model/token constants.

Parity with reference videollava/constants.py:7-27. The values are part of the
public contract: `IMAGE_TOKEN_INDEX` (-200) is the placeholder id spliced by
`tokenizer_image_token` and consumed by the fusion core; `IGNORE_INDEX` (-100)
is the label-mask value used by the training preprocessors.
"""

# Loss / label masking (reference constants.py:7)
IGNORE_INDEX = -100

# Multimodal placeholder tokens (reference constants.py:9-21)
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
IMAGE_PLACEHOLDER = "<image-placeholder>"

DEFAULT_VIDEO_TOKEN = "<video>"
DEFAULT_VIDEO_PATCH_TOKEN = "<im_patch>"
DEFAULT_VID_START_TOKEN = "<vid_start>"
DEFAULT_VID_END_TOKEN = "<vid_end>"
VIDEO_PLACEHOLDER = "<video-placeholder>"

# Sequence-length clamps (reference constants.py:24-27)
MAX_IMAGE_LENGTH = 16
MAX_VIDEO_LENGTH = 1

# Defined-but-unused in the reference; kept for API parity (constants.py:27).
PAD_LENGTH = 620

# Vision geometry of the production tower (LanguageBind_Image ViT-L/14 @ 224px):
# 224/14 = 16 -> 256 patch tokens after dropping CLS.
VISION_PATCH_TOKENS = 256
VISION_IMAGE_SIZE = 224
VISION_PATCH_SIZE = 14

# OpenAI-CLIP normalization used by the image preprocessing pipeline
# (reference .../languagebind/image/processing_image.py:12-13).
OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)
