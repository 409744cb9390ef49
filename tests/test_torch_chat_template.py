"""The port's chat-template renderer (``dynamo_tpu_torch/llm/chat_template.py``
behind ``llm/preprocessor.PromptFormatter``) against the JAX
``PromptFormatter`` (jinja2 with ``trim_blocks``, ``lstrip_blocks``, loop
controls and a plain-``json.dumps`` ``tojson``).

Exact matches, byte for byte:

- every template under ``tests/data/chat_templates`` with each
  conversation of ``test_chat_template_conformance.py``, with and without
  the generation prompt, and hermes_tools with tools;
- the three conversations the templates refuse: both renderers raise, with
  the template's own message;
- a corpus of the constructs the renderer implements (scoping, whitespace
  control, loop variables, filters, tests, methods, the undefined value),
  rendered by the JAX package's jinja2 environment.

A construct outside the renderer's subset is refused when the template is
parsed, naming it.
"""

import jinja2
import pytest

from dynamo_tpu.llm.preprocessor import PromptFormatter as JaxFormatter
from dynamo_tpu_torch.llm.chat_template import (ChatTemplate, TemplateError,
                                                TemplateSyntaxError)
from dynamo_tpu_torch.llm.preprocessor import PromptFormatter
from tests.test_chat_template_conformance import (BOS, CONVERSATIONS, EOS,
                                                  MULTI_TURN, SIMPLE,
                                                  TEMPLATES, TOOLS,
                                                  WITH_SYSTEM, load)


def _both(template: str):
    return (PromptFormatter(template, bos_token=BOS, eos_token=EOS),
            JaxFormatter(template, bos_token=BOS, eos_token=EOS))


@pytest.mark.parametrize("name", TEMPLATES)
@pytest.mark.parametrize("agp", [True, False])
def test_templates_match_jax(name, agp):
    port, ref = _both(load(name))
    for conv in CONVERSATIONS[name]:
        msgs = [dict(m) for m in conv]
        assert port.render(msgs, add_generation_prompt=agp) == \
            ref.render(msgs, add_generation_prompt=agp)


@pytest.mark.parametrize("conv", [SIMPLE, WITH_SYSTEM, MULTI_TURN])
def test_tools_render_matches_jax(conv):
    """tojson over a tool schema with &, <, >: plain json.dumps."""
    port, ref = _both(load("hermes_tools"))
    msgs = [dict(m) for m in conv]
    got = port.render(msgs, add_generation_prompt=True, tools=TOOLS)
    assert got == ref.render(msgs, add_generation_prompt=True, tools=TOOLS)
    assert "&" in got and "<for>" in got


@pytest.mark.parametrize("name,bad", [
    ("mistral", WITH_SYSTEM),                       # system unsupported
    ("gemma", WITH_SYSTEM),                         # system unsupported
    ("mistral", [{"role": "user", "content": "a"},
                 {"role": "user", "content": "b"}]),  # broken alternation
])
def test_raise_exception_matches_jax(name, bad):
    port, ref = _both(load(name))
    with pytest.raises(jinja2.TemplateError) as want:
        ref.render([dict(m) for m in bad])
    with pytest.raises(TemplateError) as got:
        port.render([dict(m) for m in bad])
    assert str(got.value) == str(want.value)


MESSAGES = [{"role": "system", "content": " be brief "},
            {"role": "user", "content": "hi <there> & you"},
            {"role": "assistant", "content": "yo",
             "tool_calls": [{"name": "f", "arguments": {"x": 1}}]}]

# (template, context) pairs: each construct the renderer implements
CONSTRUCTS = [
    # scoping: a set inside a for lives for one iteration
    ("{% set x = 1 %}{% for i in [1,2] %}{{ x }}{% set x = x + 10 %}"
     "{{ x }}{% endfor %}{{ x }}", {}),
    ("{% for i in [1,2] %}{% if i == 2 %}{{ y }}{% endif %}"
     "{% set y = i %}{% endfor %}|{{ y }}", {}),
    ("{% if true %}{% set z = 3 %}{% endif %}{{ z }}", {}),
    ("{% set ns = namespace(a=1, found=false) %}{% for m in messages %}"
     "{% if m.role == 'user' %}{% set ns.found = true %}{% endif %}"
     "{% set ns.a = ns.a + 1 %}{% endfor %}{{ ns.a }}{{ ns.found }}", {}),
    ("{% set a, b = 1, 2 %}{{ a }}{{ b }}{% set t = 1, 2 %}{{ t }}", {}),
    # whitespace control, trim_blocks / lstrip_blocks, comments, newlines
    ("  {% if true %}\n  hi\n  {% endif %}\n  x\n{# c #}\n{{- ' y ' -}}  "
     "\n z", {}),
    ("a {%+ if true %} b {% endif +%}\n c", {}),
    ("x\n\n  {#- hi -#}\n\n y", {}),
    ("\r\nline1\r\n{% if true %}\r\nline2\r\n{% endif %}\r\n", {}),
    ("{%- for m in messages -%}\n  {{- m.role -}}: {{ m['content'] }}\n"
     "{%- endfor %}\nend\n", {}),
    # loops: loop.*, filters on the iterable, else, break / continue
    ("{% for m in messages %}{{ loop.index0 }}{{ loop.index }}"
     "{{ loop.first }}{{ loop.last }}{{ loop.revindex }}{{ loop.length }}"
     "{{ loop.previtem.role if loop.previtem is defined }}|{% endfor %}",
     {}),
    ("{% for i in [1,2,3] if i != 2 %}{{ loop.index }}/{{ loop.length }}"
     "{% else %}none{% endfor %}{% for i in [] %}x{% else %}none"
     "{% endfor %}", {}),
    ("{% for i in range(5) %}{% if i == 1 %}{% continue %}{% endif %}"
     "{{ i }}{% if i == 3 %}{% break %}{% endif %}{% endfor %}", {}),
    ("{% for k, v in {'p': 1, 'q': 2}.items() %}{{ k }}={{ v }};"
     "{% endfor %}", {}),
    # expressions and precedence
    ("{{ none }}{{ true }}{{ [1,'a'] }}{{ {'a':1} }}{{ 1/2 }}{{ 7//2 }}"
     "{{ 7 % 3 }}{{ 2 ** 3 }}{{ -1 }}{{ 'a' ~ 1 ~ none }}", {}),
    ("{{ '%s-%d' % ('a', 3) }}{{ (1, 2) }}{{ 1 < 2 < 3 }}{{ 'a' in 'abc' }}"
     "{{ 'z' not in ['a'] }}{{ not false and true or false }}", {}),
    ("{{ 'x' if false }}|{{ 'y' if true else 'n' }}|"
     "{{ messages[0]['content'] if messages else 'none' }}", {}),
    ("{{ [1,2,3][1:] }}{{ 'abc'[::-1] }}{{ messages[-1].role }}"
     "{{ messages[1:]|length }}{{ [][0] }}", {}),
    ("{{ 'a' 'b' }}{{ 1e3 }}{{ 1_000 }}{{ 2.5 }}{{ \"q\\\"\" }}", {}),
    # dict attributes, the undefined value
    ("{{ messages[2].tool_calls[0].arguments.x }}{{ messages[0].name }}"
     "|{{ u.x }}", {"u": None}),
    ("{{ nope ~ 'a' }}{{ nope|length }}{{ nope|default('d') }}"
     "{{ nope is defined }}{{ nope is undefined }}{{ nope == nope }}"
     "{% for x in nope %}x{% endfor %}{% if not nope %}f{% endif %}", {}),
    # tests, filters and methods
    ("{{ messages[0].content is string }}{{ 3 is number }}"
     "{{ true is number }}{{ {} is mapping }}{{ none is none }}"
     "{{ 3 is odd }}{{ 4 is even }}{{ 3 is integer }}"
     "{{ messages[0].name is not defined }}", {}),
    ("{{ ' Ab '|trim|upper }}{{ 'X'|lower }}{{ [3,1]|first }}"
     "{{ []|first }}{{ [1,2]|last }}{{ 'ab'|list }}"
     "{{ {'a':1}|items|list }}{{ ['a','b']|join(', ') }}{{ 5|string }}"
     "{{ messages|length }}{{ ''|default('e', true) }}", {}),
    ("{{ messages|tojson }}{{ {'a': '<&>'}|tojson(indent=2) }}", {}),
    ("{{ messages[0].content.strip() }}{{ 'abc'.startswith('a') }}"
     "{{ 'abc'.endswith('b') }}{{ 'a,b'.split(',') }}{{ 'AB'.lower() }}"
     "{{ messages[0].get('role') }}{{ messages[0].get('x', 'd') }}"
     "{{ messages[0].keys()|list }}", {}),
    ("{% for m in messages %}{{ loop.cycle('odd', 'even') }}{% endfor %}",
     {}),
]


@pytest.mark.parametrize("i", range(len(CONSTRUCTS)))
def test_constructs_match_jinja(i):
    template, extra = CONSTRUCTS[i]
    ctx = {"messages": [dict(m) for m in MESSAGES], **extra}
    env = JaxFormatter(None)._env
    assert ChatTemplate(template).render(**ctx) == \
        env.from_string(template).render(**ctx)


@pytest.mark.parametrize("template", [
    "{{ nope.x }}", "{{ nope + 1 }}", "{{ nope['k'] }}", "{{ nope < 1 }}",
])
def test_undefined_raises_as_in_jinja(template):
    env = JaxFormatter(None)._env
    with pytest.raises(jinja2.UndefinedError):
        env.from_string(template).render()
    with pytest.raises(TemplateError, match="undefined"):
        ChatTemplate(template).render()


@pytest.mark.parametrize("template,construct", [
    ("{% macro f() %}{% endmacro %}", "macro"),
    ("{% generation %}x{% endgeneration %}", "generation"),
    ("{% raw %}x{% endraw %}", "raw"),
    ("{{ x|selectattr('a') }}", "selectattr"),
    ("{{ x is divisibleby(3) }}", "divisibleby"),
    ("{{ x.append(1) }}", "append"),
    ("{{ lipsum() }}", "lipsum"),
    ("{% set x %}block{% endset %}", "set"),
    ("{% for x in y recursive %}{% endfor %}", "recursive"),
])
def test_unsupported_constructs_raise_at_parse(template, construct):
    with pytest.raises(TemplateSyntaxError, match=construct):
        ChatTemplate(template)
