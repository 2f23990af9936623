"""Per-language stopword sets for the tokenizer.

Counterpart of the reference's per-language Lucene analyzers' stopword
filtering (reference: core/.../utils/text/LuceneTextAnalyzer.scala - each
language's analyzer ships its own stop set).  Function words only; used by
TextTokenizer(remove_stopwords=True) with either an explicit language or
per-row auto-detection via ops.lang_data.
"""
from __future__ import annotations

STOPWORDS: dict[str, frozenset] = {
    "en": frozenset(
        "a an and are as at be but by for from had has have he her his i if "
        "in is it its my no not of on or our she so that the their them "
        "they this to was we were what when where which who will with would "
        "you your".split()
    ),
    "fr": frozenset(
        "au aux avec ce ces dans de des du elle en et eux il ils je la le "
        "les leur lui ma mais me mes moi mon ne nos notre nous on ou où "
        "par pas pour qu que qui sa se ses son sur ta te tes toi ton tu un "
        "une vos votre vous y à été être".split()
    ),
    "es": frozenset(
        "al algo como con de del donde el ella ellas ellos en entre era "
        "eres es esta este esto ha han hay la las le les lo los me mi mis "
        "muy más nada ni no nos o para pero por que quien se sin sobre su "
        "sus también te tu tus un una uno y ya él".split()
    ),
    "de": frozenset(
        "aber als am an auch auf aus bei bin bis das dass dem den der des "
        "die doch du ein eine einem einen einer es für hat hatte ich ihr "
        "im in ist ja kann mein mich mit nach nicht noch nur oder sein "
        "sich sie sind so um und uns von war was wenn wie wir wird zu "
        "zum zur".split()
    ),
    "it": frozenset(
        "a ad al alla alle anche che chi ci come con da dal dalla de dei "
        "del della delle di e ed era gli ha hanno i il in io la le lei lo "
        "loro lui ma mi mia mio ne nei nel nella noi non o per più quella "
        "quello questa questo se si sono su sua suo tra tu un una uno "
        "voi".split()
    ),
    "pt": frozenset(
        "a ao aos as com como da das de dele do dos e ela elas ele eles em "
        "entre era essa esse esta este eu foi há isso já lhe mais mas me "
        "meu minha muito na nas no nos não nós o os ou para pela pelo por "
        "quando que quem se sem ser seu sua são também te tem um uma você "
        "à às é".split()
    ),
    "nl": frozenset(
        "aan al als bij dan dat de der des deze die dit doch door een en "
        "er had heb heeft het hij hoe ik in is je kan maar me met mijn "
        "naar niet nog nu of om onder ons ook op over te toch tot u uit "
        "van veel voor want was wat we wel werd wie wij zal ze zich zij "
        "zijn zo zou".split()
    ),
    "sv": frozenset(
        "alla att av blev bli den det denna dessa dig din de dem du där "
        "efter ej eller en er ett från för ha hade han hans har hon i "
        "icke inte jag kan man med men mig min mot mycket ni nu när och "
        "om oss på samma sedan sig sin sitt som så till under upp ut "
        "utan vad var vi vid än är över".split()
    ),
    "da": frozenset(
        "af alle andet at blev bliver da de dem den denne der deres det "
        "dette dig din dog du efter eller en end er et for fra ham han "
        "hans har havde hende hendes her hos hun hvad hvis hvor i ikke "
        "ind jeg kan man mange med meget men mig min mod ned noget nogle "
        "nu når og også om op os over på sig sin skal som sådan thi til "
        "ud under var vi vil ville vor at".split()
    ),
    "pl": frozenset(
        "a aby ale bez by być co czy dla do gdy go i ich im ja jak jako je "
        "jego jej jest jestem już ma mnie mu na nad nie niż o od on ona "
        "one oni oraz po pod przez przy się są ta tak także tam te tego "
        "tej ten to tu tym tylko w we wszystko z za że żeby".split()
    ),
    "ru": frozenset(
        "а бы был была были было в вам вас весь во вот все всех вы да для "
        "до его ее если есть еще же за и из или им их к как ко когда кто "
        "ли мне мы на над не него нее нет ни них но о об он она они оно "
        "от по под при с со так также там то того тоже только том ты у "
        "уже чем что эта эти это я".split()
    ),
    "tr": frozenset(
        "ama ancak bana ben beni bir biz bu bunu da daha de değil diye en "
        "gibi ha hem hep her hiç için ile ise kadar ki kim mi mu ne neden "
        "o olan olarak on ona onu onlar sen siz şu ve veya ya yani".split()
    ),
    "fi": frozenset(
        "ei että he hän ja jo jos joka kanssa kuin kun me mikä minä mitä "
        "mukaan mutta myös ne niin nyt ole oli olla on ovat se sekä sen "
        "siellä siinä sitä tai tämä tässä te vaan vai vain voi".split()
    ),
    "id": frozenset(
        "ada adalah akan aku anda atau bagi bahwa banyak bisa dalam dan "
        "dari dengan di dia harus ini itu jika juga kami kamu karena ke "
        "kita lagi lebih mereka oleh pada saat saya sebagai sudah telah "
        "tetapi tidak untuk yang".split()
    ),
}


def stopwords_for(language: str) -> frozenset:
    return STOPWORDS.get(language, frozenset())
