"""Gradio web demo shell (reference videollava/serve/teochat_demo.py).

Port of teochat_tpu/serve/demo.py, over the port's Chat (serve/chat.py).

The reference serves a Gradio-on-FastAPI app with temporal image upload, a
brush-mask -> bbox tool, and cv2 bbox overlays (teochat_demo.py:549-943).
gradio is not part of this deployment's baked dependencies, so this module is
import-guarded: `build_demo()` constructs the full Blocks app when gradio is
installed and raises a clear ImportError otherwise. The dependency-free
serving path is teochat_torch/serve/server.py (JSON over HTTP) + serve/chat.py.

The reference's map panel (Planet/Google/USGS tiles, teochat_demo.py:549-627)
is available through serve/maptiles with an injected `tile_fetcher` — offline
deployments render from canned tiles; only the OpenAI moderation hook is
omitted (already dead code in the reference). The example gallery
(teochat_demo.py:822-882) ships as SINGLE_IMAGE_EXAMPLES/TEMPORAL_EXAMPLES.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from teochat_torch.serve.chat import Chat, draw_bboxes, mask2bbox

EXAMPLE_PROMPTS = [
    "Describe the changes between these images.",
    "Were any buildings damaged? Answer with Yes or No.",
    "Identify all new buildings. Output bounding boxes as [x1, y1, x2, y2].",
    "Classify the level of damage experienced by the building at location "
    "[bbox] in the second image. Choose from: No damage, Minor Damage, "
    "Major Damage, Destroyed.",
]

# The reference demo's example gallery as data (teochat_demo.py:822-882).
# Paths are relative to an `example_dir` of EO chips shipped with the app;
# entries are (image, prompt) / (first_image, other_images, prompt).
SINGLE_IMAGE_EXAMPLES = [
    ("rqa.png", "What is this? [21, 3, 47, 19]"),
    ("xBD_loc.png",
     "Identify the location of the building on the right of the image using "
     "a bounding box of the form [x_min, y_min, x_max, y_max]."),
    ("AID_cls.png",
     "Classify this image as one of: Oil Refinery, Compressor Station, "
     "Pipeline, Processing Plant, Well Pad."),
    ("HRBEN_qa.png", "Is there a road next to a body of water?"),
]

TEMPORAL_EXAMPLES = [
    ("fMoW_cls_1.png",
     ["fMoW_cls_2.png", "fMoW_cls_3.png", "fMoW_cls_4.png"],
     "Classify the sequence of images as one of: flooded road, lake or "
     "pond, aquaculture, dam, mountain trail."),
    ("xBD_dis_1.png", ["xBD_dis_2.png"],
     "What disaster has occurred in the area?"),
    ("xBD_cls_1.png", ["xBD_cls_2.png"],
     "Classify the level of damage experienced by the building at location "
     "[0, 8, 49, 53]."),
    ("S2Looking_cd_1.png", ["S2Looking_cd_2.png"],
     "Identify all changed buildings using bounding boxes of the form "
     "[x_min, y_min, x_max, y_max]."),
    ("QFabric_rtqa_1.png",
     ["QFabric_rtqa_2.png", "QFabric_rtqa_3.png", "QFabric_rtqa_4.png",
      "QFabric_rtqa_5.png"],
     "In which image was construction finished?"),
]


def build_demo(
    model_path: Optional[str] = None,
    vision_path: Optional[str] = None,
    load_8bit: bool = True,
    chat: Optional[Chat] = None,
    example_dir: Optional[str] = None,
    tile_fetcher=None,
    planet_api_key: Optional[str] = None,
):
    """Construct the Gradio Blocks app. Requires the optional gradio extra.

    `example_dir` enables the reference's example gallery
    (SINGLE_IMAGE_EXAMPLES / TEMPORAL_EXAMPLES resolved against it);
    `tile_fetcher(url) -> np.ndarray` enables the map-view panel
    (teochat_demo.py:549-627) through serve/maptiles — injected so the demo
    stays functional offline with canned tiles."""
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "the web demo requires gradio (not in this deployment's baked "
            "dependencies); use teochat_torch.serve.server (JSON HTTP endpoint) "
            "or serve.chat.Chat programmatically instead"
        ) from e

    if chat is None:
        chat = Chat(model_path, load_8bit=load_8bit, vision_path=vision_path)

    def respond(images, mask_image, timestamps_text, message, temperature,
                max_new_tokens, history):
        history = history or []
        image_list: List[np.ndarray] = [np.asarray(im) for im in (images or [])]
        bbox = mask2bbox(np.asarray(mask_image)) if mask_image is not None else None
        timestamps = [t.strip() for t in (timestamps_text or "").split(",") if t.strip()]
        if timestamps and len(timestamps) != len(image_list):
            timestamps = []
        result = chat.generate(
            message, image_list, timestamps=timestamps, bbox=bbox,
            temperature=float(temperature), max_new_tokens=int(max_new_tokens),
        )
        history = history + [(message, result["response"])]
        overlays = []
        if result["bboxes"] and image_list:
            overlays = [
                draw_bboxes(im.copy(), result["bboxes"]) for im in image_list
            ]
        return history, overlays

    def reset():
        chat.reset()
        return [], []

    with gr.Blocks(title="TEOChat") as demo:
        gr.Markdown(
            "# TEOChat — temporal earth observation assistant\n"
            "Upload a chronological sequence of satellite images and ask "
            "questions about change, damage, or objects."
        )
        with gr.Row():
            with gr.Column():
                images = gr.Gallery(label="Image sequence (chronological)",
                                    type="numpy")
                mask_image = gr.Image(label="Optional region brush (bbox)",
                                      type="numpy")
                timestamps_text = gr.Textbox(
                    label="Timestamps (comma-separated YYYY-MM-DD, optional)"
                )
                temperature = gr.Slider(0.0, 1.0, value=0.2, label="temperature")
                max_new_tokens = gr.Slider(16, 1024, value=256, step=16,
                                           label="max new tokens")
            with gr.Column():
                chatbot = gr.Chatbot(label="TEOChat")
                message = gr.Textbox(label="Message")
                overlays = gr.Gallery(label="Detections")
                send = gr.Button("Send")
                clear = gr.Button("New session")
        if example_dir is not None:
            import os

            gr.Examples(
                examples=[
                    [[os.path.join(example_dir, img)], prompt]
                    for img, prompt in SINGLE_IMAGE_EXAMPLES
                ],
                inputs=[images, message],
                label="Single Image Examples",
            )
            gr.Examples(
                examples=[
                    [[os.path.join(example_dir, f) for f in [first] + rest],
                     prompt]
                    for first, rest, prompt in TEMPORAL_EXAMPLES
                ],
                inputs=[images, message],
                label="Temporal Image Examples",
            )
        else:
            gr.Examples(examples=[[p] for p in EXAMPLE_PROMPTS], inputs=[message])

        if tile_fetcher is not None:
            # map panel (teochat_demo.py:549-627) via serve/maptiles
            from teochat_torch.serve.maptiles import (
                TEMPORAL_BASEMAPS,
                get_temporal_map_images,
                render_map_view,
            )

            with gr.Row():
                lat = gr.Number(value=0.0, label="lat")
                lon = gr.Number(value=0.0, label="lon")
                zoom = gr.Slider(1, 18, value=15, step=1, label="zoom")
                basemap = gr.Dropdown(
                    choices=list(TEMPORAL_BASEMAPS) + ["Google Maps"],
                    value="Google Maps", label="basemap",
                )
                map_view = gr.Image(label="map view", type="numpy")
                map_single = gr.Button("Use map image")
                map_temporal = gr.Button("Use temporal map sequence")

            def fetch_single(lat_v, lon_v, zoom_v, basemap_v):
                img = render_map_view(
                    float(lat_v), float(lon_v), int(zoom_v), basemap_v,
                    fetcher=tile_fetcher, planet_api_key=planet_api_key,
                )
                return img, [img]

            def fetch_temporal(lat_v, lon_v, zoom_v):
                imgs = get_temporal_map_images(
                    float(lat_v), float(lon_v), int(zoom_v),
                    fetcher=tile_fetcher, planet_api_key=planet_api_key,
                )
                return imgs[0], imgs

            map_single.click(
                fetch_single, [lat, lon, zoom, basemap], [map_view, images]
            )
            map_temporal.click(
                fetch_temporal, [lat, lon, zoom], [map_view, images]
            )

        state = gr.State([])
        send.click(
            respond,
            [images, mask_image, timestamps_text, message, temperature,
             max_new_tokens, state],
            [chatbot, overlays],
        )
        clear.click(reset, [], [chatbot, overlays])
    return demo


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="TEOChat gradio demo")
    p.add_argument("--model_path", required=True)
    p.add_argument("--vision_path", default=None)
    p.add_argument("--load_8bit", action="store_true", default=True)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    args = p.parse_args(argv)
    demo = build_demo(args.model_path, args.vision_path, args.load_8bit)
    demo.launch(server_name=args.host, server_port=args.port)


if __name__ == "__main__":
    main()
