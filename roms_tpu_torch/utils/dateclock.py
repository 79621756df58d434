"""Calendar / model-clock utilities (ROMS/Utility/dateclock.F).

Implements the reference's two calendars (dateclock.F:52-148):
 * proleptic Gregorian ("standard"): the astronomical day-0 origin
   (-4713-11-24 in the proleptic Gregorian calendar); conversions use
   the Fliegel & Van Flandern integer Julian-day algebra.
 * 360_day: twelve 30-day months.

The model clock is `time` in seconds from a reference date given as the
YYYYMMDD.dd float `dstart` convention of roms_*.in.  All functions are
plain Python/NumPy (host-side setup and output metadata, never inside
jit - matching the reference, which calls caldate only at I/O points).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_MONTH = ("January", "February", "March", "April", "May", "June",
          "July", "August", "September", "October", "November",
          "December")
_DAYS_IN_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


@dataclass(frozen=True)
class CalDate:
    """The reference's caldate output bundle (dateclock.F:162-320)."""
    year: int
    month: int
    day: int
    hour: int
    minute: int
    second: float
    yday: int          # 1-based day of year
    tday: float        # fractional days since the calendar origin


def is_leap(year: int, calendar: str = "standard") -> bool:
    """Gregorian leap rule (dateclock.F yearday logic)."""
    if calendar == "360_day":
        return False
    return (year % 4 == 0 and year % 100 != 0) or (year % 400 == 0)


def ymd_to_jdn(year: int, month: int, day: int) -> int:
    """Gregorian (proleptic) date -> Julian Day Number (Fliegel & Van
    Flandern 1968, the algorithm in dateclock.F datenum)."""
    a = (14 - month) // 12
    y = year + 4800 - a
    m = month + 12 * a - 3
    return (day + (153 * m + 2) // 5 + 365 * y + y // 4 - y // 100 +
            y // 400 - 32045)


def jdn_to_ymd(jdn: int):
    """Julian Day Number -> proleptic Gregorian (y, m, d)."""
    a = jdn + 32044
    b = (4 * a + 3) // 146097
    c = a - 146097 * b // 4
    d = (4 * c + 3) // 1461
    e = c - 1461 * d // 4
    m = (5 * e + 2) // 153
    day = e - (153 * m + 2) // 5 + 1
    month = m + 3 - 12 * (m // 10)
    year = 100 * b + d - 4800 + m // 10
    return year, month, day

# ROMS day-number origin: datenum(-4713, 11, 24) = 0 for the proleptic
# Gregorian calendar (dateclock.F:57-63)
_JDN0 = ymd_to_jdn(-4713, 11, 24)


def datenum(year: int, month: int, day: int, hour: int = 0,
            minute: int = 0, second: float = 0.0,
            calendar: str = "standard") -> float:
    """Fractional day number since the calendar origin (dateclock.F
    datenum)."""
    if calendar == "360_day":
        dn = 360.0 * year + 30.0 * (month - 1) + (day - 1)
    else:
        dn = float(ymd_to_jdn(year, month, day) - _JDN0)
    return dn + hour / 24.0 + minute / 1440.0 + second / 86400.0


def dstart_to_datenum(dstart: float, calendar: str = "standard") -> float:
    """roms_*.in DSTART convention YYYYMMDD.dd -> day number."""
    ymd = int(dstart)
    frac = dstart - ymd
    year, rem = divmod(ymd, 10000)
    month, day = divmod(rem, 100)
    return datenum(year, max(month, 1), max(day, 1),
                   calendar=calendar) + frac


def caldate(tday: float, calendar: str = "standard") -> CalDate:
    """Fractional day number -> calendar date (dateclock.F caldate)."""
    dfrac, dn = np.modf(tday)
    dn = int(dn)
    if calendar == "360_day":
        year, rem = divmod(dn, 360)
        month, day0 = divmod(rem, 30)
        month += 1
        day = day0 + 1
        yday = 30 * (month - 1) + day
    else:
        year, month, day = jdn_to_ymd(dn + _JDN0)
        yday = dn - (ymd_to_jdn(year, 1, 1) - _JDN0) + 1
    sec = dfrac * 86400.0
    hour = int(sec // 3600.0)
    minute = int((sec - 3600.0 * hour) // 60.0)
    second = sec - 3600.0 * hour - 60.0 * minute
    return CalDate(year=year, month=month, day=day, hour=hour,
                   minute=minute, second=second, yday=yday, tday=tday)


def yearday(tday: float, calendar: str = "standard") -> float:
    """Fractional year-day in [1, 366) (the caldate yd_dp output used by
    e.g. the red-tide endogenous clock and ana_srflux)."""
    cd = caldate(tday, calendar)
    return cd.yday + cd.hour / 24.0 + cd.minute / 1440.0 + \
        cd.second / 86400.0


def time_string(tday: float, calendar: str = "standard") -> str:
    """'YYYY-MM-DD hh:mm:ss.ss' stamp (dateclock.F time_string)."""
    cd = caldate(tday, calendar)
    return (f"{cd.year:04d}-{cd.month:02d}-{cd.day:02d} "
            f"{cd.hour:02d}:{cd.minute:02d}:{cd.second:05.2f}")


def time_units(dstart_datenum: float, calendar: str = "standard") -> str:
    """CF units attribute for output files (def_info.F time units)."""
    return ("seconds since " + time_string(dstart_datenum, calendar) +
            (" 360_day" if calendar == "360_day" else ""))
