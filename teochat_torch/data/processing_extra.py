"""Video / depth / audio / thermal preprocessing, torch-free (the port's own
copy of teochat_tpu/data/processing_extra.py, over the port's
data/processing.py::ImageProcessor).

Rebuilds the LanguageBind modality pipelines the reference vendors:
- video (processing_video.py:26-165): decode + uniform temporal subsample
  to num_frames + per-frame resize/crop/normalize. The reference applies
  RandomHorizontalFlipVideo(0.5) even at inference (:38) — a quirk TEOChat
  never hits (the eval path drops the video tower); here flipping is
  training-only and off by default. Decoding a file needs cv2 (or decord /
  pytorchvideo); without it a path raises that library's ImportError, while
  arrays and lists of decoded frames need none of them.
- depth (processing_depth.py:17-30): min-max normalize to [0,1], 3-channel.
- thermal: image pipeline on single-channel data.
- audio (processing_audio.py:19-30): log-mel spectrogram, 3 stacked channels
  (numpy/scipy in place of torchaudio).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from teochat_torch.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
from teochat_torch.data.processing import ImageProcessor


def uniform_frame_indices(total: int, num_frames: int) -> np.ndarray:
    """Uniform temporal subsample (pytorchvideo UniformTemporalSubsample)."""
    if total <= 0:
        raise ValueError("empty video")
    return np.linspace(0, total - 1, num_frames).round().astype(np.int64)


class VideoProcessor:
    """Decode + subsample + per-frame image transform -> [T, 3, H, W] or
    stacked [N, T, 3, H, W] via preprocess().

    `video_decode_backend` mirrors the reference's three decoders
    (processing_video.py:26-114: opencv | decord | pytorchvideo) — identical
    transform math downstream, different decode libraries. All three are
    optional imports, made when a path is decoded; opencv is the default,
    as in the reference's eval configs.
    An unknown backend raises NameError like the reference."""

    BACKENDS = ("opencv", "decord", "pytorchvideo")

    def __init__(self, num_frames: int = 8, size: int = 224,
                 random_flip: bool = False,
                 video_decode_backend: str = "opencv"):
        if video_decode_backend not in self.BACKENDS:
            # reference raises NameError with this wording
            # (processing_video.py:66-67)
            raise NameError(
                "video_decode_backend should specify in "
                "(pytorchvideo, decord, opencv)"
            )
        self.num_frames = num_frames
        self.image = ImageProcessor(size=size)
        self.random_flip = random_flip
        self.video_decode_backend = video_decode_backend

    def _decode(self, path: str) -> List[np.ndarray]:
        if self.video_decode_backend == "decord":
            return self._decode_decord(path)
        if self.video_decode_backend == "pytorchvideo":
            return self._decode_pytorchvideo(path)
        return self._decode_opencv(path)

    def _decode_opencv(self, path: str) -> List[np.ndarray]:
        import cv2

        cap = cv2.VideoCapture(path)
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        idxs = set(uniform_frame_indices(max(total, 1), self.num_frames).tolist())
        frames, i = {}, 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if i in idxs:
                frames[i] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            i += 1
        cap.release()
        if not frames:
            raise ValueError(f"no frames decoded from {path}")
        ordered = [frames[j] for j in sorted(frames)]
        while len(ordered) < self.num_frames:  # short video: repeat last
            ordered.append(ordered[-1])
        return ordered

    def _decode_decord(self, path: str) -> List[np.ndarray]:
        """decord VideoReader.get_batch over linspace ids
        (processing_video.py:90-97)."""
        try:
            from decord import VideoReader, cpu
        except ImportError as e:
            raise ImportError(
                "video_decode_backend='decord' but decord is not installed; "
                "use the default 'opencv' backend"
            ) from e
        vr = VideoReader(path, ctx=cpu(0))
        ids = uniform_frame_indices(len(vr), self.num_frames)
        batch = vr.get_batch(ids.tolist())
        arr = batch.asnumpy() if hasattr(batch, "asnumpy") else np.asarray(batch)
        return [arr[i] for i in range(arr.shape[0])]  # already RGB [H, W, 3]

    def _decode_pytorchvideo(self, path: str) -> List[np.ndarray]:
        """pytorchvideo EncodedVideo clip + uniform temporal subsample
        (processing_video.py:79-87)."""
        try:
            from pytorchvideo.data.encoded_video import EncodedVideo
        except ImportError as e:
            raise ImportError(
                "video_decode_backend='pytorchvideo' but pytorchvideo is not "
                "installed; use the default 'opencv' backend"
            ) from e
        video = EncodedVideo.from_path(path, decode_audio=False)
        clip = video.get_clip(start_sec=0.0, end_sec=video.duration)
        data = clip["video"]  # [C, T, H, W] torch tensor
        arr = np.asarray(data.permute(1, 2, 3, 0).cpu())  # -> [T, H, W, C]
        ids = uniform_frame_indices(arr.shape[0], self.num_frames)
        return [arr[i].astype(np.uint8) for i in ids]

    def _transform_one(self, video) -> np.ndarray:
        if isinstance(video, str):
            frames = self._decode(video)
        elif isinstance(video, (list, tuple)):
            frames = list(video)
            idxs = uniform_frame_indices(len(frames), self.num_frames)
            frames = [frames[i] for i in idxs]
        else:  # [T, H, W, 3] array
            arr = np.asarray(video)
            idxs = uniform_frame_indices(arr.shape[0], self.num_frames)
            frames = [arr[i] for i in idxs]
        out = self.image.preprocess(frames)["pixel_values"]  # [T, 3, H, W]
        if self.random_flip and np.random.random() < 0.5:
            out = out[..., ::-1].copy()
        return out

    def preprocess(self, videos, return_tensors: str = "np") -> Dict[str, np.ndarray]:
        if isinstance(videos, (str, np.ndarray)):
            videos = [videos]
        return {"pixel_values": np.stack([self._transform_one(v) for v in videos])}

    __call__ = preprocess


class DepthProcessor:
    """Min-max normalize depth to [0,1], replicate to 3 channels, then the
    image transform (reference processing_depth.py:17-30)."""

    def __init__(self, size: int = 224, max_depth: Optional[float] = None):
        self.image = ImageProcessor(size=size)
        self.max_depth = max_depth

    def preprocess(self, depths, return_tensors: str = "np") -> Dict[str, np.ndarray]:
        if not isinstance(depths, list):
            depths = [depths]
        outs = []
        for d in depths:
            arr = np.asarray(d, np.float32)
            if arr.ndim == 3:
                arr = arr[..., 0]
            hi = self.max_depth if self.max_depth else (arr.max() or 1.0)
            arr = np.clip(arr / hi, 0, 1)
            rgb = (np.stack([arr] * 3, axis=-1) * 255).astype(np.uint8)
            outs.append(self.image.preprocess(rgb)["pixel_values"][0])
        return {"pixel_values": np.stack(outs)}

    __call__ = preprocess


class ThermalProcessor(DepthProcessor):
    """Thermal frames share the depth normalization path."""


class AudioProcessor:
    """waveform -> 3x stacked log-mel spectrogram image, CLIP-normalized
    (reference processing_audio.py:19-30, torchaudio-free)."""

    def __init__(self, sample_rate: int = 16000, num_mels: int = 112,
                 target_length: int = 1036, size: int = 224):
        self.sample_rate = sample_rate
        self.num_mels = num_mels
        self.target_length = target_length
        self.image_size = size

    def _mel(self, wav: np.ndarray) -> np.ndarray:
        from scipy.signal import stft

        _, _, spec = stft(
            wav, fs=self.sample_rate, nperseg=400, noverlap=400 - 160,
            padded=True,
        )
        power = np.abs(spec) ** 2  # [freq, time]
        n_freq = power.shape[0]
        # triangular mel filterbank
        def hz_to_mel(f):
            return 2595.0 * np.log10(1.0 + f / 700.0)

        def mel_to_hz(m):
            return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

        mel_pts = mel_to_hz(
            np.linspace(hz_to_mel(0), hz_to_mel(self.sample_rate / 2), self.num_mels + 2)
        )
        freqs = np.linspace(0, self.sample_rate / 2, n_freq)
        fb = np.zeros((self.num_mels, n_freq), np.float32)
        for i in range(self.num_mels):
            l, c, r = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
            up = (freqs - l) / max(c - l, 1e-6)
            down = (r - freqs) / max(r - c, 1e-6)
            fb[i] = np.clip(np.minimum(up, down), 0, None)
        mel = fb @ power
        return np.log(mel + 1e-10)

    def preprocess(self, waveforms, return_tensors: str = "np") -> Dict[str, np.ndarray]:
        if not isinstance(waveforms, list):
            waveforms = [waveforms]
        outs = []
        for wav in waveforms:
            m = self._mel(np.asarray(wav, np.float32))  # [mels, time]
            t = m.shape[1]
            if t < self.target_length:
                m = np.pad(m, ((0, 0), (0, self.target_length - t)))
            else:
                m = m[:, : self.target_length]
            m = (m - m.mean()) / (m.std() + 1e-6)
            # resize to the ViT input geometry, stack 3 channels
            from PIL import Image

            img = Image.fromarray(
                ((m - m.min()) / (np.ptp(m) + 1e-6) * 255).astype(np.uint8)
            ).resize((self.image_size, self.image_size), Image.BICUBIC)
            arr = np.asarray(img, np.float32) / 255.0
            arr = (arr - np.mean(OPENAI_DATASET_MEAN)) / np.mean(OPENAI_DATASET_STD)
            outs.append(np.stack([arr] * 3, axis=0))
        return {"pixel_values": np.stack(outs)}

    __call__ = preprocess
