"""Builtin chat-template dialects + detection (a copy of
``llama_cpp_gfx906_tpu/chat/templates.py``).

Reference: src/llama-chat.{h,cpp} — 45 hardcoded dialects selected by
substring fingerprints of the model's Jinja template, used when Jinja
rendering is disabled or the template is unknown.  This module covers the
widely-deployed subset; everything else goes through the Jinja path in
chat.render.
"""

from __future__ import annotations


def detect_template(tmpl: str | None) -> str:
    """Map a Jinja template string (or alias name) to a dialect id.

    Mirrors the fingerprinting approach of llm_chat_detect_template
    (llama-chat.cpp) — checks distinctive tokens in the template text."""
    if not tmpl:
        return "chatml"
    t = tmpl
    # alias names ("llama2", "chatml", ...) pass straight through
    if "{" not in t and "<" not in t and "[" not in t:
        return t.strip().lower().replace("-", "_")
    if "<|im_start|>" in t:
        return "chatml"
    if "<|start_header_id|>" in t and "<|end_header_id|>" in t:
        return "llama3"
    if "[gMASK]<sop>" in t:
        return "chatglm4"
    if "<start_of_turn>" in t:
        return "gemma"
    if "<|START_OF_TURN_TOKEN|>" in t:
        return "command_r"
    if "<|prompt|>" in t and "<|answer|>" in t:
        return "monarch"
    if "<|user|>" in t and "<|end|>" in t:
        return "phi3"
    if "<|assistant|>" in t and "<|user|>" in t:
        return "zephyr"
    if "<｜User｜>" in t or "<|User|>" in t:
        return "deepseek3"
    if "USER:" in t and "ASSISTANT:" in t:
        return "vicuna"
    if "[INST]" in t:
        if "<<SYS>>" in t:
            # llama2 sys variants (llama-chat.cpp:116-124)
            if "content.strip()" in t:
                return "llama2_sys_strip"
            if "bos_token + '[INST]" in t:
                return "llama2_sys_bos"
            return "llama2_sys"
        if "[SYSTEM_PROMPT]" in t:
            return "mistral_v7" if "[SYSTEM_PROMPT] " in t else "mistral_v7_tekken"
        if "\" [INST] \"" in t or "' [INST] '" in t:
            return "mistral_v1"
        return "mistral_v3" if "[/INST]" in t else "llama2"
    if "<｜hy_Assistant｜>" in t:
        return "hunyuan_dense" if "hy_place" in t else "hunyuan_moe"
    if "<|im_assistant|>assistant<|im_middle|>" in t:
        return "kimi_k2"
    if "<|startoftext|>" in t and "<|endoftext|>" in t:
        return "granite" if "<|start_of_role|>" in t else "orion"
    if "<|start_of_role|>" in t:
        return "granite"
    if "GPT4 Correct" in t:
        return "openchat"
    if "<|start|>" in t and "<|channel|>" in t:
        return "openai_moe"
    return "unknown"


def _sys_merge(messages: list[dict]) -> tuple[str, list[dict]]:
    """Pull out the (first) system message; return (system, rest)."""
    system = ""
    rest = []
    for m in messages:
        if m["role"] == "system" and not system:
            system = m.get("content") or ""
        else:
            rest.append(m)
    return system, rest


def apply_builtin_template(
    dialect: str, messages: list[dict], add_generation_prompt: bool = True
) -> str:
    """Render with a hardcoded dialect (llm_chat_apply_template analog)."""
    out: list[str] = []
    d = dialect

    if d in ("chatml", "unknown"):
        for m in messages:
            out.append(f"<|im_start|>{m['role']}\n{m.get('content') or ''}<|im_end|>\n")
        if add_generation_prompt:
            out.append("<|im_start|>assistant\n")
    elif d == "llama3":
        for m in messages:
            out.append(
                f"<|start_header_id|>{m['role']}<|end_header_id|>\n\n{m.get('content') or ''}<|eot_id|>"
            )
        if add_generation_prompt:
            out.append("<|start_header_id|>assistant<|end_header_id|>\n\n")
    elif d in ("llama2_sys_bos", "llama2_sys_strip"):
        # reference llama2 variant algorithm (llama-chat.cpp, is_inside_turn)
        strip_msg = d == "llama2_sys_strip"
        bos_hist = d == "llama2_sys_bos"
        out.append("[INST] ")
        inside = True
        for m in messages:
            c = (m.get("content") or "")
            if strip_msg:
                c = c.strip()
            if not inside:
                inside = True
                out.append("<s>[INST] " if bos_hist else "[INST] ")
            if m["role"] == "system":
                out.append(f"<<SYS>>\n{c}\n<</SYS>>\n\n")
            elif m["role"] == "user":
                out.append(f"{c} [/INST]")
            else:
                out.append(f"{c}</s>")
                inside = False
    elif d == "mistral_v3_tekken":
        # v3-tekken: no leading/trailing spaces, assistant not trimmed
        inside = False
        for m in messages:
            c = m.get("content") or ""
            if not inside:
                out.append("[INST]")
                inside = True
            if m["role"] == "system":
                out.append(f"{c}\n\n")
            elif m["role"] == "user":
                out.append(f"{c}[/INST]")
            else:
                out.append(f"{c}</s>")
                inside = False
    elif d == "mistral_v7_tekken":
        for m in messages:
            c = m.get("content") or ""
            if m["role"] == "system":
                out.append(f"[SYSTEM_PROMPT]{c}[/SYSTEM_PROMPT]")
            elif m["role"] == "user":
                out.append(f"[INST]{c}[/INST]")
            else:
                out.append(f"{c}</s>")
    elif d == "hunyuan_dense":
        for i, m in enumerate(messages):
            c = m.get("content") or ""
            if i == 0 and m["role"] == "system":
                out.append(f"{c}<｜hy_place▁holder▁no▁3｜>")
            if m["role"] == "assistant":
                out.append(f"<｜hy_Assistant｜>{c}<｜hy_place▁holder▁no▁2｜>")
            elif m["role"] == "user":
                out.append(f"<｜hy_User｜>{c}<｜hy_Assistant｜>")
    elif d == "kimi_k2":
        tags = {"system": "<|im_system|>system<|im_middle|>",
                "user": "<|im_user|>user<|im_middle|>",
                "assistant": "<|im_assistant|>assistant<|im_middle|>",
                "tool": "<|im_system|>tool<|im_middle|>"}
        for m in messages:
            out.append(tags.get(m["role"], "") + (m.get("content") or "") + "<|im_end|>")
        if add_generation_prompt:
            out.append("<|im_assistant|>assistant<|im_middle|>")
    elif d in ("llama2", "llama2_sys", "mistral_v1", "mistral_v3"):
        system, rest = _sys_merge(messages)
        pending_sys = system
        for m in rest:
            c = m.get("content") or ""
            if m["role"] == "user":
                if pending_sys:
                    if d == "llama2_sys":
                        c = f"<<SYS>>\n{pending_sys}\n<</SYS>>\n\n{c}"
                    else:
                        c = f"{pending_sys}\n\n{c}"
                    pending_sys = ""
                sep = " " if d in ("llama2", "llama2_sys", "mistral_v1") else ""
                out.append(f"[INST]{' ' if sep else ''}{c}{' ' if sep else ''}[/INST]")
            elif m["role"] == "assistant":
                out.append(f" {c}</s>" if d != "mistral_v3" else f" {c}</s>")
    elif d == "mistral_v7":
        for m in messages:
            c = m.get("content") or ""
            if m["role"] == "system":
                out.append(f"[SYSTEM_PROMPT] {c}[/SYSTEM_PROMPT]")
            elif m["role"] == "user":
                out.append(f"[INST] {c}[/INST]")
            else:
                out.append(f" {c}</s>")
    elif d in ("phi3", "phi4"):
        for m in messages:
            out.append(f"<|{m['role']}|>\n{m.get('content') or ''}<|end|>\n")
        if add_generation_prompt:
            out.append("<|assistant|>\n")
    elif d == "zephyr":
        for m in messages:
            out.append(f"<|{m['role']}|>\n{m.get('content') or ''}<|endoftext|>\n")
        if add_generation_prompt:
            out.append("<|assistant|>\n")
    elif d == "monarch":
        for i, m in enumerate(messages):
            bos = "" if i == 0 else "<s>"
            tag = {"system": "system", "user": "prompt", "assistant": "answer"}[m["role"]]
            out.append(f"{bos}{tag}\n{m.get('content') or ''}</s>\n")
        if add_generation_prompt:
            out.append("<s>answer\n")
    elif d == "gemma":
        system, rest = _sys_merge(messages)
        pending = system
        for m in rest:
            role = "model" if m["role"] == "assistant" else "user"
            c = m.get("content") or ""
            if pending and role == "user":
                c = f"{pending}\n\n{c}"
                pending = ""
            out.append(f"<start_of_turn>{role}\n{c}<end_of_turn>\n")
        if add_generation_prompt:
            out.append("<start_of_turn>model\n")
    elif d == "orion":
        system, rest = _sys_merge(messages)
        for m in rest:
            if m["role"] == "user":
                out.append(f"Human: {m.get('content') or ''}\n\nAssistant: </s>")
            else:
                out.append(f"{m.get('content') or ''}</s>")
    elif d == "openchat":
        for m in messages:
            role = {"system": "", "user": "GPT4 Correct User: ", "assistant": "GPT4 Correct Assistant: "}[m["role"]]
            out.append(f"{role}{m.get('content') or ''}<|end_of_turn|>")
        if add_generation_prompt:
            out.append("GPT4 Correct Assistant:")
    elif d in ("vicuna", "vicuna_orca"):
        for m in messages:
            c = m.get("content") or ""
            if m["role"] == "system":
                out.append(f"SYSTEM: {c}\n" if d == "vicuna_orca" else f"{c}\n\n")
            elif m["role"] == "user":
                out.append(f"USER: {c}\n")
            else:
                out.append(f"ASSISTANT: {c}</s>\n")
        if add_generation_prompt:
            out.append("ASSISTANT:")
    elif d == "deepseek3":
        system, rest = _sys_merge(messages)
        if system:
            out.append(system)
        for m in rest:
            c = m.get("content") or ""
            if m["role"] == "user":
                out.append(f"<｜User｜>{c}")
            else:
                out.append(f"<｜Assistant｜>{c}<｜end▁of▁sentence｜>")
        if add_generation_prompt:
            out.append("<｜Assistant｜>")
    elif d == "command_r":
        for m in messages:
            role = {"system": "SYSTEM", "user": "USER", "assistant": "CHATBOT"}[m["role"]]
            out.append(
                f"<|START_OF_TURN_TOKEN|><|{role}_TOKEN|>{(m.get('content') or '').strip()}<|END_OF_TURN_TOKEN|>"
            )
        if add_generation_prompt:
            out.append("<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>")
    elif d == "chatglm4":
        out.append("[gMASK]<sop>")
        for m in messages:
            out.append(f"<|{m['role']}|>\n{m.get('content') or ''}")
        if add_generation_prompt:
            out.append("<|assistant|>")
    elif d == "granite":
        for m in messages:
            out.append(
                f"<|start_of_role|>{m['role']}<|end_of_role|>{m.get('content') or ''}<|end_of_text|>\n"
            )
        if add_generation_prompt:
            out.append("<|start_of_role|>assistant<|end_of_role|>")
    elif d == "falcon3":
        for m in messages:
            out.append(f"<|{m['role']}|>\n{m.get('content') or ''}\n")
        if add_generation_prompt:
            out.append("<|assistant|>\n")
    elif d == "openai_moe":
        # gpt-oss harmony-style (assistant turns close with <|return|>)
        for m in messages:
            end = "<|return|>" if m["role"] == "assistant" else "<|end|>"
            out.append(f"<|start|>{m['role']}<|message|>{m.get('content') or ''}{end}")
        if add_generation_prompt:
            out.append("<|start|>assistant")
    elif d == "deepseek":
        for m in messages:
            c = m.get("content") or ""
            if m["role"] == "system":
                out.append(c)
            elif m["role"] == "user":
                out.append(f"### Instruction:\n{c}\n")
            else:
                out.append(f"### Response:\n{c}\n<|EOT|>\n")
        if add_generation_prompt:
            out.append("### Response:\n")
    elif d == "deepseek2":
        for m in messages:
            c = m.get("content") or ""
            if m["role"] == "system":
                out.append(f"{c}\n\n")
            elif m["role"] == "user":
                out.append(f"User: {c}\n\n")
            else:
                out.append(f"Assistant: {c}<｜end▁of▁sentence｜>")
        if add_generation_prompt:
            out.append("Assistant:")
    elif d == "chatglm3":
        out.append("[gMASK]sop")
        for m in messages:
            out.append(f"<|{m['role']}|>\n {m.get('content') or ''}")
        if add_generation_prompt:
            out.append("<|assistant|>")
    elif d == "glmedge":
        for m in messages:
            out.append(f"<|{m['role']}|>\n{m.get('content') or ''}")
        if add_generation_prompt:
            out.append("<|assistant|>")
    elif d == "minicpm":
        for m in messages:
            c = (m.get("content") or "").strip()
            if m["role"] == "user":
                out.append(f"<用户>{c}<AI>")
            else:
                out.append(c)
    elif d in ("exaone3", "exaone4"):
        for m in messages:
            c = (m.get("content") or "").strip()
            if m["role"] == "system":
                out.append(f"[|system|]{c}[|endofturn|]\n")
            elif m["role"] == "user":
                out.append(f"[|user|]{c}\n")
            elif m["role"] == "tool" and d == "exaone4":
                out.append(f"[|tool|]{c}[|endofturn|]\n")
            else:
                out.append(f"[|assistant|]{c}[|endofturn|]\n")
        if add_generation_prompt:
            out.append("[|assistant|]")
    elif d == "rwkv_world":
        for i, m in enumerate(messages):
            c = (m.get("content") or "").strip()
            if m["role"] == "system":
                out.append(f"System: {c}\n\n")
            elif m["role"] == "user":
                out.append(f"User: {c}\n\n")
                if i == len(messages) - 1:
                    out.append("Assistant:")
            else:
                out.append(f"Assistant: {c}\n\n")
    elif d == "gigachat":
        msgs = list(messages)
        if msgs and msgs[0]["role"] == "system":
            out.append(f"<s>{msgs[0].get('content') or ''}<|message_sep|>")
            msgs = msgs[1:]
        else:
            out.append("<s>")
        for m in msgs:
            c = m.get("content") or ""
            if m["role"] == "user":
                out.append(
                    f"user<|role_sep|>{c}<|message_sep|>"
                    "available functions<|role_sep|>[]<|message_sep|>"
                )
            elif m["role"] == "assistant":
                out.append(f"assistant<|role_sep|>{c}<|message_sep|>")
        if add_generation_prompt:
            out.append("assistant<|role_sep|>")
    elif d == "megrez":
        for m in messages:
            out.append(f"<|role_start|>{m['role']}<|role_end|>{m.get('content') or ''}<|turn_end|>")
        if add_generation_prompt:
            out.append("<|role_start|>assistant<|role_end|>")
    elif d == "yandex":
        for m in messages:
            c = m.get("content") or ""
            if m["role"] == "user":
                out.append(f" Пользователь: {c}\n\n")
            elif m["role"] == "assistant":
                out.append(f" Ассистент: {c}\n\n")
        if add_generation_prompt:
            out.append(" Ассистент:[SEP]")
    elif d == "bailing":
        for m in messages:
            role = "HUMAN" if m["role"] == "user" else m["role"].upper()
            out.append(f"<role>{role}</role>{m.get('content') or ''}")
        if add_generation_prompt:
            out.append("<role>ASSISTANT</role>")
    elif d == "llama4":
        for m in messages:
            c = (m.get("content") or "").strip()
            out.append(f"<|header_start|>{m['role']}<|header_end|>\n\n{c}<|eot|>")
        if add_generation_prompt:
            out.append("<|header_start|>assistant<|header_end|>\n\n")
    elif d == "smolvlm":
        out.append("<|im_start|>")
        for m in messages:
            c = m.get("content") or ""
            if m["role"] == "system":
                out.append(f"{c}\n\n")
            elif m["role"] == "user":
                out.append(f"User: {c}<end_of_utterance>\n")
            else:
                out.append(f"Assistant: {c}<end_of_utterance>\n")
        if add_generation_prompt:
            out.append("Assistant:")
    elif d == "dots1":
        for m in messages:
            c = m.get("content") or ""
            if m["role"] == "system":
                out.append(f"<|system|>{c}<|endofsystem|>")
            elif m["role"] == "user":
                out.append(f"<|userprompt|>{c}<|endofuserprompt|>")
            else:
                out.append(f"<|response|>{c}<|endofresponse|>")
        if add_generation_prompt:
            out.append("<|response|>")
    elif d == "hunyuan_moe":
        for m in messages:
            c = m.get("content") or ""
            if m["role"] == "system":
                out.append(f"<|startoftext|>{c}<|extra_4|>")
            elif m["role"] == "assistant":
                out.append(f"{c}<|eos|>")
            else:
                out.append(f"<|startoftext|>{c}<|extra_0|>")
    else:
        raise ValueError(f"unsupported builtin chat dialect: {dialect}")
    return "".join(out)


BUILTIN_DIALECTS = (
    "chatml", "llama2", "llama2_sys", "llama2_sys_bos", "llama2_sys_strip",
    "llama3", "llama4", "mistral_v1", "mistral_v3", "mistral_v3_tekken",
    "mistral_v7", "mistral_v7_tekken", "phi3", "phi4", "zephyr", "monarch",
    "gemma", "orion", "openchat", "vicuna", "vicuna_orca", "deepseek",
    "deepseek2", "deepseek3", "command_r", "chatglm3", "chatglm4", "glmedge",
    "granite", "falcon3", "openai_moe", "minicpm", "exaone3", "exaone4",
    "rwkv_world", "gigachat", "megrez", "yandex", "bailing", "smolvlm",
    "dots1", "hunyuan_moe", "hunyuan_dense", "kimi_k2",
)
