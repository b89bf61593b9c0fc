"""Whisper language inventory (public OpenAI vocabulary metadata).

The 99-language code->name table and its aliases, as required for the
multilingual special-token layout (reference whisper/tokenizer.py:10-128).
The *order* of this table is load-bearing: language token ids are assigned as
``sot + 1 + index``.
"""

_LANGUAGE_ITEMS = (
    "en:english zh:chinese de:german es:spanish ru:russian ko:korean fr:french "
    "ja:japanese pt:portuguese tr:turkish pl:polish ca:catalan nl:dutch "
    "ar:arabic sv:swedish it:italian id:indonesian hi:hindi fi:finnish "
    "vi:vietnamese he:hebrew uk:ukrainian el:greek ms:malay cs:czech "
    "ro:romanian da:danish hu:hungarian ta:tamil no:norwegian th:thai ur:urdu "
    "hr:croatian bg:bulgarian lt:lithuanian la:latin mi:maori ml:malayalam "
    "cy:welsh sk:slovak te:telugu fa:persian lv:latvian bn:bengali sr:serbian "
    "az:azerbaijani sl:slovenian kn:kannada et:estonian mk:macedonian "
    "br:breton eu:basque is:icelandic hy:armenian ne:nepali mn:mongolian "
    "bs:bosnian kk:kazakh sq:albanian sw:swahili gl:galician mr:marathi "
    "pa:punjabi si:sinhala km:khmer sn:shona yo:yoruba so:somali af:afrikaans "
    "oc:occitan ka:georgian be:belarusian tg:tajik sd:sindhi gu:gujarati "
    "am:amharic yi:yiddish lo:lao uz:uzbek fo:faroese ht:haitian_creole "
    "ps:pashto tk:turkmen nn:nynorsk mt:maltese sa:sanskrit lb:luxembourgish "
    "my:myanmar bo:tibetan tl:tagalog mg:malagasy as:assamese tt:tatar "
    "haw:hawaiian ln:lingala ha:hausa ba:bashkir jw:javanese su:sundanese "
    "yue:cantonese"
)

LANGUAGES = {
    code: name.replace("_", " ")
    for code, name in (item.split(":") for item in _LANGUAGE_ITEMS.split())
}

# Language-code lookup by name, plus aliases (reference tokenizer.py:114-128).
TO_LANGUAGE_CODE = {
    **{name: code for code, name in LANGUAGES.items()},
    "burmese": "my",
    "valencian": "ca",
    "flemish": "nl",
    "haitian": "ht",
    "letzeburgesch": "lb",
    "pushto": "ps",
    "panjabi": "pa",
    "moldavian": "ro",
    "moldovan": "ro",
    "sinhalese": "si",
    "castilian": "es",
    "mandarin": "zh",
}
