"""Chat formatting (port of ``render_chat_template`` from
``llama_cpp_gfx906_tpu/chat/__init__.py``): Jinja rendering of the model's
own template, the builtin dialects by name or by fingerprint when the
template fails, and the chatml fallback when the model has none.  Tool-call
parsing is not ported: the server refuses ``tools``.
"""

from __future__ import annotations

import datetime
import json

from .templates import BUILTIN_DIALECTS, apply_builtin_template, detect_template

CHATML_FALLBACK = (
    "{% for message in messages %}"
    "<|im_start|>{{ message.role }}\n{{ message.content }}<|im_end|>\n"
    "{% endfor %}"
    "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}"
)


def render_chat_template(template: str | None, messages: list[dict],
                         add_generation_prompt: bool = True, bos_token: str = "",
                         eos_token: str = "", **extra) -> str:
    """Render a conversation.  Uses the model's Jinja template when given;
    falls back to the detected builtin dialect on template errors.  A bare
    builtin dialect name renders that dialect directly."""
    if template in BUILTIN_DIALECTS:
        return apply_builtin_template(template, messages, add_generation_prompt)
    import jinja2

    env = jinja2.Environment(loader=jinja2.BaseLoader(), trim_blocks=True,
                             lstrip_blocks=True,
                             extensions=["jinja2.ext.loopcontrols"])
    env.filters["tojson"] = lambda value, **kw: json.dumps(value, ensure_ascii=False)
    env.globals["raise_exception"] = _raise_exception
    env.globals["strftime_now"] = lambda fmt: datetime.datetime.now().strftime(fmt)
    try:
        tpl = env.from_string(template or CHATML_FALLBACK)
        return tpl.render(messages=messages,
                          add_generation_prompt=add_generation_prompt,
                          bos_token=bos_token, eos_token=eos_token, **extra)
    except Exception:  # noqa: BLE001 (any template fault: the reference falls back too)
        dialect = detect_template(template)
        if dialect not in BUILTIN_DIALECTS:
            dialect = "chatml"
        return apply_builtin_template(dialect, messages, add_generation_prompt)


def _raise_exception(msg):
    raise ValueError(msg)


__all__ = ["render_chat_template", "apply_builtin_template", "detect_template",
           "BUILTIN_DIALECTS", "CHATML_FALLBACK"]
