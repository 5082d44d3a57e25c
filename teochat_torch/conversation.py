"""Conversation templates: the prompt-rendering state machine.

Behavior-parity rebuild of reference videollava/conversation.py:6-377. The template
*strings* (system prompts, role names, separators) are part of the checkpoint
contract — TEOChat was trained on the Vicuna ``v1`` rendering — so they must match
byte-for-byte. The implementation here is fresh: a frozen-ish dataclass with a
style-dispatched renderer and no torch/gradio coupling.
"""

from __future__ import annotations

import dataclasses
from enum import Enum, auto
from typing import Any, List, Sequence


class SeparatorStyle(Enum):
    """Prompt separator styles (reference conversation.py:6-12)."""

    SINGLE = auto()
    TWO = auto()
    MPT = auto()
    PLAIN = auto()
    LLAMA_2 = auto()


def _msg_text(message: Any) -> str:
    """Messages may be ``(text, images, process_mode)`` tuples in serving flows."""
    if isinstance(message, tuple):
        return message[0]
    return message


@dataclasses.dataclass
class Conversation:
    """Conversation history + rendering rules (reference conversation.py:15-104)."""

    system: str
    roles: Sequence[str]
    messages: List[List[Any]]
    offset: int
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: str = None
    version: str = "Unknown"
    skip_next: bool = False

    def get_prompt(self) -> str:
        messages = self.messages
        # Serving flows store the first user turn as (text, image, mode); the
        # rendering contract moves the <image> tag to the front of that turn
        # (reference conversation.py:30-39).
        if len(messages) > 0 and isinstance(messages[0][1], tuple):
            messages = [list(m) for m in self.messages]
            init_role, init_msg = messages[0]
            init_text = init_msg[0].replace("<image>", "").strip()
            if "mmtag" in self.version:
                messages[0] = [init_role, init_text]
                messages.insert(0, [self.roles[0], "<Image><image></Image>"])
                messages.insert(1, [self.roles[1], "Received."])
            else:
                messages[0] = [init_role, "<image>\n" + init_text]

        style = self.sep_style
        if style == SeparatorStyle.SINGLE:
            parts = [self.system, self.sep]
            for role, message in messages:
                if message:
                    parts += [role, ": ", _msg_text(message), self.sep]
                else:
                    parts += [role, ":"]
            return "".join(parts)

        if style == SeparatorStyle.TWO:
            seps = (self.sep, self.sep2)
            parts = [self.system, seps[0]]
            for i, (role, message) in enumerate(messages):
                if message:
                    parts += [role, ": ", _msg_text(message), seps[i % 2]]
                else:
                    parts += [role, ":"]
            return "".join(parts)

        if style == SeparatorStyle.MPT:
            parts = [self.system, self.sep]
            for role, message in messages:
                if message:
                    parts += [role, _msg_text(message), self.sep]
                else:
                    parts += [role]
            return "".join(parts)

        if style == SeparatorStyle.LLAMA_2:
            def wrap_sys(msg: str) -> str:
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n"

            def wrap_inst(msg: str) -> str:
                return f"[INST] {msg} [/INST]"

            ret = ""
            for i, (role, message) in enumerate(messages):
                if i == 0:
                    assert message, "first message should not be none"
                    assert role == self.roles[0], "first message should come from user"
                if message:
                    text = _msg_text(message)
                    if i == 0:
                        text = wrap_sys(self.system) + text
                    if i % 2 == 0:
                        ret += self.sep + wrap_inst(text)
                    else:
                        ret += " " + text + " " + self.sep2
            return ret.lstrip(self.sep)

        if style == SeparatorStyle.PLAIN:
            seps = (self.sep, self.sep2)
            parts = [self.system]
            for i, (role, message) in enumerate(messages):
                if message:
                    parts += [_msg_text(message), seps[i % 2]]
            return "".join(parts)

        raise ValueError(f"Invalid style: {self.sep_style}")

    def append_message(self, role: str, message: Any) -> None:
        self.messages.append([role, message])

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
        )

    def dict(self) -> dict:
        return {
            "system": self.system,
            "roles": self.roles,
            "messages": [
                [r, _msg_text(m)] if isinstance(m, tuple) else [r, m]
                for r, m in self.messages
            ],
            "offset": self.offset,
            "sep": self.sep,
            "sep2": self.sep2,
        }


# --- Template registry (reference conversation.py:252-377). Only templates the
# --- TEOChat stack exercises are kept: v1 (production), llama_2, plain, mpt,
# --- and their llava variants.

conv_vicuna_v1 = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's questions.",
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llama_2 = Conversation(
    system="""You are a helpful, respectful and honest assistant. Always answer as helpfully as possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and positive in nature.

If a question does not make any sense, or is not factually coherent, explain why instead of answering something not correct. If you don't know the answer to a question, please don't share false information.""",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_llava_llama_2 = Conversation(
    system="You are a helpful language and vision assistant. "
    "You are able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language.",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_mpt = Conversation(
    system="""<|im_start|>system
A conversation between a user and an LLM-based AI assistant. The assistant gives helpful and honest answers.""",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

conv_vicuna_v0 = Conversation(
    # Byte-parity with reference conversation.py:220-251: the "default"/"v0"
    # template ships SEEDED with a one-shot transcript (offset=2 hides it from
    # gradio but get_prompt renders it). No active TEOChat path uses it; kept
    # for full prompt-layer parity.
    system="A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"),
    messages=[
        ["Human", "What are the key differences between renewable and non-renewable energy sources?"],
        ["Assistant",
            "Renewable energy sources are those that can be replenished naturally in a relatively "
            "short amount of time, such as solar, wind, hydro, geothermal, and biomass. "
            "Non-renewable energy sources, on the other hand, are finite and will eventually be "
            "depleted, such as coal, oil, and natural gas. Here are some key differences between "
            "renewable and non-renewable energy sources:\n"
            "1. Availability: Renewable energy sources are virtually inexhaustible, while non-renewable "
            "energy sources are finite and will eventually run out.\n"
            "2. Environmental impact: Renewable energy sources have a much lower environmental impact "
            "than non-renewable sources, which can lead to air and water pollution, greenhouse gas emissions, "
            "and other negative effects.\n"
            "3. Cost: Renewable energy sources can be more expensive to initially set up, but they typically "
            "have lower operational costs than non-renewable sources.\n"
            "4. Reliability: Renewable energy sources are often more reliable and can be used in more remote "
            "locations than non-renewable sources.\n"
            "5. Flexibility: Renewable energy sources are often more flexible and can be adapted to different "
            "situations and needs, while non-renewable sources are more rigid and inflexible.\n"
            "6. Sustainability: Renewable energy sources are more sustainable over the long term, while "
            "non-renewable sources are not, and their depletion can lead to economic and social instability.\n"],
    ],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_llava_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_llava_v0_mmtag = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
    "The assistant is able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language."
    "The visual content will be provided with the following format: "
    "<Image>visual content</Image>.",
    roles=("Human", "Assistant"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0_mmtag",
)

conv_llava_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
)

conv_llava_v1 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llava_v1_mmtag = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
    "The assistant is able to understand the visual content that the user provides, "
    "and assist the user with a variety of tasks using natural language."
    "The visual content will be provided with the following format: "
    "<Image>visual content</Image>.",
    roles=("USER", "ASSISTANT"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1_mmtag",
)

default_conversation = conv_vicuna_v1
conv_templates = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "llava_v0": conv_llava_v0,
    "v0_mmtag": conv_llava_v0_mmtag,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "plain": conv_llava_plain,
    "v0_plain": conv_llava_plain,
    "llava_v1": conv_llava_v1,
    "v1_mmtag": conv_llava_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,
    "mpt": conv_mpt,
}
