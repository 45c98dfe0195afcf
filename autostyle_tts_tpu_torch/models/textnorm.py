"""Text normalization (TN): number/date/abbreviation expansion for EN/ZH/JA.

The reference's synthesis engine shipped full TN inside its text frontend
(SURVEY §2.3.1 "Text frontend" row — CosyVoice used a ttsfrd-class
normalizer); round 1 only did NFKC + punctuation, so "123" reached the LM as
byte digits. This module verbalizes:

  EN: cardinals (with , grouping), ordinals, decimals, percentages,
      currency ($/£/€), times (3:30), years (1999/2024), No. 5,
      long digit strings (read digit-by-digit), title/common abbreviations
  ZH: cardinals (一百二十三), decimals (三点一四), percent (百分之…),
      currency (¥/元), years read digit-wise (2024年 → 二零二四年),
      dates (5月3日), times (3:30 → 三点三十分), digit strings
  JA: kanji cardinals with JA idioms (105 → 百五, 100 → 百, 10000 → 一万),
      years as cardinals (2024年 → 二千二十四年), dates, clock times with
      時 (3:30 → 三時三十分), Nパーセント, 円, digit strings with 〇

Host-side, pure Python, deterministic; runs BEFORE tokenization. Language
comes from the caller (tag or frontend.detect_language).
"""

from __future__ import annotations

import re
from typing import List

# ----------------------------------------------------------------- EN numbers

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE = [(10 ** 9, "billion"), (10 ** 6, "million"), (10 ** 3, "thousand")]

_ORD_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def num_to_words_en(n: int) -> str:
    """Cardinal verbalization, 0 <= n < 1e12."""
    if n < 0:
        return "minus " + num_to_words_en(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, r = divmod(n, 10)
        return _TENS[t] + ("-" + _ONES[r] if r else "")
    if n < 1000:
        h, r = divmod(n, 100)
        return _ONES[h] + " hundred" + (" " + num_to_words_en(r) if r else "")
    for base, name in _SCALE:
        if n >= base:
            q, r = divmod(n, base)
            return (num_to_words_en(q) + " " + name
                    + (" " + num_to_words_en(r) if r else ""))
    return " ".join(_ONES[int(d)] for d in str(n))  # >= 1e12: digit-wise


def ordinal_to_words_en(n: int) -> str:
    w = num_to_words_en(n)
    head, _, last = w.rpartition(" ")
    if "-" in last:
        th, _, lo = last.rpartition("-")
        last = th + "-" + _ordinalize(lo)
    else:
        last = _ordinalize(last)
    return (head + " " + last) if head else last


def _ordinalize(word: str) -> str:
    if word in _ORD_SPECIAL:
        return _ORD_SPECIAL[word]
    if word.endswith("y"):
        return word[:-1] + "ieth"
    if word.endswith("t"):  # hundred/thousand handled upstream
        return word + "h"
    return word + "th"


def year_to_words_en(n: int) -> str:
    """1999 -> nineteen ninety-nine, 2005 -> two thousand five,
    2024 -> twenty twenty-four, 1900 -> nineteen hundred."""
    if 1000 <= n <= 9999:
        hi, lo = divmod(n, 100)
        if lo == 0:
            return num_to_words_en(hi) + " hundred"
        if 2000 <= n <= 2009:
            return num_to_words_en(n)
        if lo < 10:
            return num_to_words_en(hi) + " oh " + num_to_words_en(lo)
        return num_to_words_en(hi) + " " + num_to_words_en(lo)
    return num_to_words_en(n)


def digits_to_words_en(s: str) -> str:
    return " ".join(_ONES[int(d)] for d in s)


# ---------------------------------------------------------------- EN patterns

_EN_ABBREV = {
    "mr.": "mister", "mrs.": "missus", "ms.": "miss", "dr.": "doctor",
    "st.": "saint", "ave.": "avenue", "blvd.": "boulevard", "rd.": "road",
    "jr.": "junior", "sr.": "senior", "prof.": "professor",
    "vs.": "versus", "etc.": "et cetera", "e.g.": "for example",
    "i.e.": "that is", "approx.": "approximately",
    "jan.": "january", "feb.": "february", "mar.": "march",
    "apr.": "april", "aug.": "august", "sept.": "september",
    "oct.": "october", "nov.": "november", "dec.": "december",
}
_CURRENCY_EN = {"$": ("dollar", "cent"), "£": ("pound", "penny"),
                "€": ("euro", "cent")}

_RE_CURRENCY = re.compile(r"([$£€])\s?(\d[\d,]*)(?:\.(\d{1,2}))?")
_RE_PERCENT = re.compile(r"(\d[\d,]*(?:\.\d+)?)\s?%")
_RE_TIME = re.compile(r"\b(\d{1,2}):(\d{2})(?::\d{2})?\b")
_RE_ORDINAL = re.compile(r"\b(\d+)(st|nd|rd|th)\b", re.IGNORECASE)
_RE_NO = re.compile(r"\b[Nn]o\.\s?(\d+)")
_RE_DECIMAL = re.compile(r"\b(\d[\d,]*)\.(\d+)\b")
_RE_YEAR = re.compile(r"\b(1[1-9]\d{2}|20\d{2})s?\b")
_RE_LONGDIGITS = re.compile(r"\b\d{7,}\b")
_RE_INT = re.compile(r"\b\d[\d,]*\b")


def _strip_commas(s: str) -> int:
    return int(s.replace(",", ""))


def _plural(n: int, word: str) -> str:
    if n == 1:
        return word
    return word + ("ies" if word.endswith("y") else "s")


# Word boundaries matter: without the left guard, ordinary words ending in an
# abbreviation key get mangled ("first." -> "firsaint", "mar." -> "march").
_RE_ABBREV = re.compile(
    "(?<![A-Za-z0-9])(?:"
    + "|".join(re.escape(k) for k in sorted(_EN_ABBREV, key=len, reverse=True))
    + r")(?!\w)",
    re.IGNORECASE,
)


def normalize_en(text: str) -> str:
    # abbreviations first (case-insensitive, match with trailing dot)
    def abbrev_sub(m: "re.Match[str]") -> str:
        return _EN_ABBREV[m.group(0).lower()]

    text = _RE_ABBREV.sub(abbrev_sub, text)

    def currency_sub(m: "re.Match[str]") -> str:
        unit, cents_u = _CURRENCY_EN[m.group(1)]
        whole = _strip_commas(m.group(2))
        out = num_to_words_en(whole) + " " + _plural(whole, unit)
        if m.group(3):
            c = int(m.group(3).ljust(2, "0"))
            if c:
                out += " " + num_to_words_en(c) + " " + _plural(c, cents_u)
        return out

    text = _RE_CURRENCY.sub(currency_sub, text)

    def percent_sub(m: "re.Match[str]") -> str:
        return _number_token_en(m.group(1)) + " percent"

    text = _RE_PERCENT.sub(percent_sub, text)
    text = _RE_NO.sub(lambda m: "number " + num_to_words_en(int(m.group(1))),
                      text)

    def time_sub(m: "re.Match[str]") -> str:
        h, mi = int(m.group(1)), int(m.group(2))
        if not (0 <= h <= 24):
            return m.group(0)
        if mi == 0:
            return num_to_words_en(h) + " o'clock"
        if mi < 10:
            return num_to_words_en(h) + " oh " + num_to_words_en(mi)
        return num_to_words_en(h) + " " + num_to_words_en(mi)

    text = _RE_TIME.sub(time_sub, text)
    text = _RE_ORDINAL.sub(lambda m: ordinal_to_words_en(int(m.group(1))),
                           text)

    def decimal_sub(m: "re.Match[str]") -> str:
        return (num_to_words_en(_strip_commas(m.group(1))) + " point "
                + digits_to_words_en(m.group(2)))

    text = _RE_DECIMAL.sub(decimal_sub, text)
    text = _RE_LONGDIGITS.sub(lambda m: digits_to_words_en(m.group(0)), text)

    def year_sub(m: "re.Match[str]") -> str:
        y = int(m.group(1))
        w = year_to_words_en(y)
        if m.group(0).endswith("s"):  # decades: the 1990s
            if w.endswith("y"):
                w = w[:-1] + "ies"
            else:
                w += "s"
        return w

    text = _RE_YEAR.sub(year_sub, text)
    text = _RE_INT.sub(lambda m: num_to_words_en(_strip_commas(m.group(0))),
                       text)
    return re.sub(r"\s+", " ", text).strip()


def _number_token_en(s: str) -> str:
    if "." in s:
        a, b = s.split(".", 1)
        return num_to_words_en(_strip_commas(a)) + " point " + \
            digits_to_words_en(b)
    return num_to_words_en(_strip_commas(s))


# ----------------------------------------------------------------- ZH numbers

_ZH_DIGITS = "零一二三四五六七八九"
_ZH_UNITS = ["", "十", "百", "千"]
_ZH_GROUPS = ["", "万", "亿", "万亿"]


def num_to_words_zh(n: int) -> str:
    """Standard Chinese cardinal reading, 0 <= n < 1e16 (beyond the group
    table the number is read digit-wise, like phone numbers — never raise
    from inside a synthesis request)."""
    if n < 0:
        return "负" + num_to_words_zh(-n)
    if n == 0:
        return "零"
    if n >= 10 ** (4 * len(_ZH_GROUPS)):
        return digits_to_words_zh(str(n))
    groups: List[int] = []
    while n:
        groups.append(n % 10000)
        n //= 10000
    parts: List[str] = []
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        if g == 0:
            if parts and not parts[-1].endswith("零"):
                parts.append("零")
            continue
        s = ""
        zero_pending = False
        for pos in range(3, -1, -1):
            d = (g // 10 ** pos) % 10
            if d == 0:
                if s:
                    zero_pending = True
                continue
            if zero_pending:
                s += "零"
                zero_pending = False
            s += _ZH_DIGITS[d] + _ZH_UNITS[pos]
        # leading-zero inside the group relative to a higher group
        if gi < len(groups) - 1 and g < 1000 and parts and parts[-1] != "零":
            s = "零" + s
        parts.append(s + _ZH_GROUPS[gi])
    out = "".join(parts).rstrip("零")
    # 一十X -> 十X (10-19 idiom) only when it's the very head
    if out.startswith("一十"):
        out = out[1:]
    return out


def digits_to_words_zh(s: str) -> str:
    return "".join(_ZH_DIGITS[int(d)] for d in s)


_RE_ZH_YEAR = re.compile(r"(\d{2,4})年")
_RE_ZH_DATE = re.compile(r"(\d{1,2})月(\d{1,2})(日|号)")
_RE_ZH_TIME = re.compile(r"(\d{1,2}):(\d{2})(?::\d{2})?")
_RE_ZH_PERCENT = re.compile(r"(\d[\d,]*(?:\.\d+)?)\s?%")
_RE_ZH_CURRENCY = re.compile(r"[¥￥]\s?(\d[\d,]*(?:\.\d+)?)|(\d[\d,]*(?:\.\d+)?)元")
_RE_ZH_DECIMAL = re.compile(r"(\d[\d,]*)\.(\d+)")
_RE_ZH_LONG = re.compile(r"\d{7,}")
_RE_ZH_INT = re.compile(r"\d[\d,]*")


def _zh_value(s: str) -> str:
    s = s.replace(",", "")
    if "." in s:
        a, b = s.split(".", 1)
        return num_to_words_zh(int(a)) + "点" + digits_to_words_zh(b)
    return num_to_words_zh(int(s))


def normalize_zh(text: str) -> str:
    text = _RE_ZH_YEAR.sub(
        lambda m: digits_to_words_zh(m.group(1)) + "年", text)
    text = _RE_ZH_DATE.sub(
        lambda m: num_to_words_zh(int(m.group(1))) + "月"
        + num_to_words_zh(int(m.group(2))) + m.group(3), text)

    def time_sub(m: "re.Match[str]") -> str:
        h, mi = int(m.group(1)), int(m.group(2))
        if not (0 <= h <= 24):
            return m.group(0)
        out = num_to_words_zh(h) + "点"
        if mi:
            if mi < 10:
                out += "零" + num_to_words_zh(mi) + "分"
            else:
                out += num_to_words_zh(mi) + "分"
        return out

    text = _RE_ZH_TIME.sub(time_sub, text)
    text = _RE_ZH_PERCENT.sub(lambda m: "百分之" + _zh_value(m.group(1)), text)
    text = _RE_ZH_CURRENCY.sub(
        lambda m: _zh_value(m.group(1) or m.group(2)) + "元", text)
    text = _RE_ZH_DECIMAL.sub(
        lambda m: num_to_words_zh(int(m.group(1).replace(",", ""))) + "点"
        + digits_to_words_zh(m.group(2)), text)
    text = _RE_ZH_LONG.sub(lambda m: digits_to_words_zh(m.group(0)), text)
    text = _RE_ZH_INT.sub(lambda m: num_to_words_zh(int(m.group(0).replace(",", ""))),
                          text)
    return text


# ----------------------------------------------------------------- JA numbers

# Japanese kanji readings differ from Chinese in three structural ways the
# ZH rules get wrong: no interior zero marker (105 = 百五, not 一百零五),
# no leading 一 before 十/百/千 (100 = 百, 1000 = 千 — but 10000 keeps it:
# 一万), and clock readings use 時 (三時三十分), not 点. Digit-wise strings
# read with 〇 for zero; percent is パーセント; yen is 円.

_JA_DIGITS = "〇一二三四五六七八九"
_JA_UNITS = ["", "十", "百", "千"]
_JA_GROUPS = ["", "万", "億", "兆"]


def num_to_words_ja(n: int) -> str:
    """Standard Japanese kanji cardinal, 0 <= n < 1e16 (beyond the group
    table the number is read digit-wise — never raise from inside a
    synthesis request)."""
    if n < 0:
        return "マイナス" + num_to_words_ja(-n)
    if n == 0:
        return "ゼロ"
    if n >= 10 ** (4 * len(_JA_GROUPS)):
        return digits_to_words_ja(str(n))
    groups: List[int] = []
    while n:
        groups.append(n % 10000)
        n //= 10000
    parts: List[str] = []
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        if g == 0:
            continue
        s = ""
        for pos in range(3, -1, -1):
            d = (g // 10 ** pos) % 10
            if d == 0:
                continue
            # drop the 一 before 十/百 (JA idiom: 十万, 百万), and before 千
            # only in the ones group (1000 = 千); higher groups keep it
            # (一千万, 一千億). 万/億/兆 themselves keep it too (一万, 一億).
            if d == 1 and (pos in (1, 2) or (pos == 3 and gi == 0)):
                s += _JA_UNITS[pos]
            else:
                s += _JA_DIGITS[d] + _JA_UNITS[pos]
        if gi > 0 and s == "":
            continue
        if gi > 0 and g == 1:
            s = "一"
        parts.append(s + _JA_GROUPS[gi])
    return "".join(parts)


def digits_to_words_ja(s: str) -> str:
    return "".join(_JA_DIGITS[int(d)] for d in s)


_RE_JA_YEAR = re.compile(r"(\d{2,4})年")
_RE_JA_DATE = re.compile(r"(\d{1,2})月(\d{1,2})日")
_RE_JA_TIME = re.compile(r"(\d{1,2}):(\d{2})(?::\d{2})?")
_RE_JA_PERCENT = re.compile(r"(\d[\d,]*(?:\.\d+)?)\s?[%％]")
_RE_JA_CURRENCY = re.compile(r"[¥￥]\s?(\d[\d,]*(?:\.\d+)?)|(\d[\d,]*(?:\.\d+)?)円")
_RE_JA_DECIMAL = re.compile(r"(\d[\d,]*)\.(\d+)")
_RE_JA_LONG = re.compile(r"\d{7,}")
_RE_JA_INT = re.compile(r"\d[\d,]*")


def _ja_value(s: str) -> str:
    s = s.replace(",", "")
    if "." in s:
        a, b = s.split(".", 1)
        return num_to_words_ja(int(a)) + "点" + digits_to_words_ja(b)
    return num_to_words_ja(int(s))


def normalize_ja(text: str) -> str:
    # years read as cardinals (2024年 -> 二千二十四年), unlike ZH digit-wise
    text = _RE_JA_YEAR.sub(
        lambda m: num_to_words_ja(int(m.group(1))) + "年", text)
    text = _RE_JA_DATE.sub(
        lambda m: num_to_words_ja(int(m.group(1))) + "月"
        + num_to_words_ja(int(m.group(2))) + "日", text)

    def time_sub(m: "re.Match[str]") -> str:
        h, mi = int(m.group(1)), int(m.group(2))
        if not (0 <= h <= 24):
            return m.group(0)
        out = num_to_words_ja(h) + "時"
        if mi:
            out += num_to_words_ja(mi) + "分"
        return out

    text = _RE_JA_TIME.sub(time_sub, text)
    text = _RE_JA_PERCENT.sub(
        lambda m: _ja_value(m.group(1)) + "パーセント", text)
    text = _RE_JA_CURRENCY.sub(
        lambda m: _ja_value(m.group(1) or m.group(2)) + "円", text)
    text = _RE_JA_DECIMAL.sub(
        lambda m: num_to_words_ja(int(m.group(1).replace(",", ""))) + "点"
        + digits_to_words_ja(m.group(2)), text)
    text = _RE_JA_LONG.sub(lambda m: digits_to_words_ja(m.group(0)), text)
    text = _RE_JA_INT.sub(
        lambda m: num_to_words_ja(int(m.group(0).replace(",", ""))), text)
    return text


def normalize_numbers(text: str, language: str) -> str:
    """Language-dispatched TN (EN / ZH / JA). yue/ko route to the ZH digit
    rules (shared Han numeral system) — same behaviour class as the
    reference's frontend, which ran one normalizer per script family."""
    if language == "en":
        return normalize_en(text)
    if language in ("jp", "ja"):
        return normalize_ja(text)
    return normalize_zh(text)
