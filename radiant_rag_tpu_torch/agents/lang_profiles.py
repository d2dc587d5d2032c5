"""Character n-gram language profiles: the offline language detector.

The port's copy of `radiant_rag_tpu/agents/lang_profiles.py`, its seed
texts, profiles and scoring unchanged, so both packages classify every text
alike (`tests/test_torch_language.py`). Per-language character 1-4-gram
profiles are built at first use from the short seed sentences below;
classification is IDF-weighted log-tf cosine in n-gram space, gated by
Unicode script so only plausible candidates compete (Cyrillic text never
matches Spanish, and the classifier separates languages within a script
family: uk / ru, fa / ar, hi / mr).

Coverage: about 50 languages: the Latin- and Cyrillic-script profiles
below, Arabic-script (ar / fa / ur) and Devanagari (hi / mr / ne), and the
single-language scripts detected structurally (zh / ja / ko / th / el / he /
ka / hy / bn / ta / te / kn / ml / gu / pa / si / my / km / lo / am). The
confusable clusters (Scandinavian, Czech / Slovak, Iberian, Malay, Turkic)
carry extra seed text in _SEED_EXTRA because their profiles overlap.
Plain Python: no device work.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Optional, Tuple

# ISO 639-1 code -> English name (shape parity with the reference's 176-code
# map, language_detection.py:1-123).
LANGUAGE_NAMES: Dict[str, str] = {
    "aa": "Afar", "ab": "Abkhazian", "af": "Afrikaans", "am": "Amharic",
    "ar": "Arabic", "as": "Assamese", "ay": "Aymara", "az": "Azerbaijani",
    "ba": "Bashkir", "be": "Belarusian", "bg": "Bulgarian", "bh": "Bihari",
    "bi": "Bislama", "bn": "Bengali", "bo": "Tibetan", "br": "Breton",
    "bs": "Bosnian", "ca": "Catalan", "co": "Corsican", "cs": "Czech",
    "cy": "Welsh", "da": "Danish", "de": "German", "dz": "Dzongkha",
    "el": "Greek", "en": "English", "eo": "Esperanto", "es": "Spanish",
    "et": "Estonian", "eu": "Basque", "fa": "Persian", "fi": "Finnish",
    "fj": "Fijian", "fo": "Faroese", "fr": "French", "fy": "Frisian",
    "ga": "Irish", "gd": "Scottish Gaelic", "gl": "Galician",
    "gn": "Guarani", "gu": "Gujarati", "ha": "Hausa", "he": "Hebrew",
    "hi": "Hindi", "hr": "Croatian", "ht": "Haitian Creole",
    "hu": "Hungarian", "hy": "Armenian", "ia": "Interlingua",
    "id": "Indonesian", "ig": "Igbo", "is": "Icelandic", "it": "Italian",
    "ja": "Japanese", "jv": "Javanese", "ka": "Georgian", "kk": "Kazakh",
    "kl": "Greenlandic", "km": "Khmer", "kn": "Kannada", "ko": "Korean",
    "ks": "Kashmiri", "ku": "Kurdish", "ky": "Kyrgyz", "la": "Latin",
    "lb": "Luxembourgish", "ln": "Lingala", "lo": "Lao", "lt": "Lithuanian",
    "lv": "Latvian", "mg": "Malagasy", "mi": "Maori", "mk": "Macedonian",
    "ml": "Malayalam", "mn": "Mongolian", "mr": "Marathi", "ms": "Malay",
    "mt": "Maltese", "my": "Burmese", "ne": "Nepali", "nl": "Dutch",
    "no": "Norwegian", "oc": "Occitan", "om": "Oromo", "or": "Odia",
    "pa": "Punjabi", "pl": "Polish", "ps": "Pashto", "pt": "Portuguese",
    "qu": "Quechua", "rm": "Romansh", "rn": "Rundi", "ro": "Romanian",
    "ru": "Russian", "rw": "Kinyarwanda", "sa": "Sanskrit", "sd": "Sindhi",
    "sg": "Sango", "si": "Sinhala", "sk": "Slovak", "sl": "Slovenian",
    "sm": "Samoan", "sn": "Shona", "so": "Somali", "sq": "Albanian",
    "sr": "Serbian", "ss": "Swati", "st": "Sotho", "su": "Sundanese",
    "sv": "Swedish", "sw": "Swahili", "ta": "Tamil", "te": "Telugu",
    "tg": "Tajik", "th": "Thai", "ti": "Tigrinya", "tk": "Turkmen",
    "tl": "Tagalog", "tn": "Tswana", "to": "Tongan", "tr": "Turkish",
    "ts": "Tsonga", "tt": "Tatar", "ug": "Uyghur", "uk": "Ukrainian",
    "ur": "Urdu", "uz": "Uzbek", "vi": "Vietnamese", "wo": "Wolof",
    "xh": "Xhosa", "yi": "Yiddish", "yo": "Yoruba", "zh": "Chinese",
    "zu": "Zulu",
}

# Script groups: profiles only compete within their group. Single-language
# scripts short-circuit without profiles.
_SINGLE_SCRIPT: List[Tuple[str, Tuple[int, int]]] = [
    ("zh", (0x4E00, 0x9FFF)),
    ("ja", (0x3040, 0x30FF)),   # kana (Japanese also uses Han; kana decides)
    ("ko", (0xAC00, 0xD7AF)),
    ("th", (0x0E00, 0x0E7F)),
    ("el", (0x0370, 0x03FF)),
    ("he", (0x0590, 0x05FF)),
    ("ka", (0x10A0, 0x10FF)),
    ("hy", (0x0530, 0x058F)),
    ("bn", (0x0980, 0x09FF)),
    ("ta", (0x0B80, 0x0BFF)),
    ("te", (0x0C00, 0x0C7F)),
    ("kn", (0x0C80, 0x0CFF)),
    ("ml", (0x0D00, 0x0D7F)),
    ("gu", (0x0A80, 0x0AFF)),
    ("pa", (0x0A00, 0x0A7F)),
    ("si", (0x0D80, 0x0DFF)),
    ("my", (0x1000, 0x109F)),
    ("km", (0x1780, 0x17FF)),
    ("lo", (0x0E80, 0x0EFF)),
    ("am", (0x1200, 0x137F)),
]

_GROUP_SCRIPT: List[Tuple[str, Tuple[int, int]]] = [
    ("cyrillic", (0x0400, 0x04FF)),
    ("arabic", (0x0600, 0x06FF)),
    ("devanagari", (0x0900, 0x097F)),
]

# Seed corpora (lang -> text). A few generic sentences each; trigram
# profiles are built from these at first classify() call.
_SEEDS: Dict[str, Tuple[str, str]] = {
    # --- latin ----------------------------------------------------------
    "en": ("latin", "The weather is very nice today and the children are "
           "playing in the garden. I would like to know what time the train "
           "leaves tomorrow morning. This book was written by a famous "
           "author many years ago. We have been waiting for the results of "
           "the election all night."),
    "de": ("latin", "Das Wetter ist heute sehr schön und die Kinder spielen "
           "im Garten. Ich möchte wissen, wann der Zug morgen früh abfährt. "
           "Dieses Buch wurde vor vielen Jahren von einem berühmten "
           "Schriftsteller geschrieben. Wir haben die ganze Nacht auf die "
           "Ergebnisse der Wahl gewartet."),
    "fr": ("latin", "Le temps est très beau aujourd'hui et les enfants "
           "jouent dans le jardin. Je voudrais savoir à quelle heure part "
           "le train demain matin. Ce livre a été écrit par un auteur "
           "célèbre il y a de nombreuses années. Nous avons attendu les "
           "résultats de l'élection toute la nuit."),
    "es": ("latin", "El tiempo está muy bonito hoy y los niños juegan en el "
           "jardín. Me gustaría saber a qué hora sale el tren mañana por la "
           "mañana. Este libro fue escrito por un autor famoso hace muchos "
           "años. Hemos estado esperando los resultados de las elecciones "
           "toda la noche."),
    "it": ("latin", "Il tempo è molto bello oggi e i bambini giocano in "
           "giardino. Vorrei sapere a che ora parte il treno domani "
           "mattina. Questo libro è stato scritto da un autore famoso molti "
           "anni fa. Abbiamo aspettato i risultati delle elezioni tutta la "
           "notte."),
    "pt": ("latin", "O tempo está muito bonito hoje e as crianças estão "
           "brincando no jardim. Eu gostaria de saber a que horas o trem "
           "parte amanhã de manhã. Este livro foi escrito por um autor "
           "famoso há muitos anos. Estivemos esperando os resultados da "
           "eleição a noite toda."),
    "nl": ("latin", "Het weer is vandaag erg mooi en de kinderen spelen in "
           "de tuin. Ik zou graag willen weten hoe laat de trein morgenochtend "
           "vertrekt. Dit boek werd vele jaren geleden door een beroemde "
           "schrijver geschreven. We hebben de hele nacht op de uitslag van "
           "de verkiezingen gewacht."),
    "sv": ("latin", "Vädret är mycket fint idag och barnen leker i "
           "trädgården. Jag skulle vilja veta när tåget går imorgon bitti. "
           "Den här boken skrevs av en berömd författare för många år "
           "sedan. Vi har väntat på resultaten av valet hela natten."),
    "da": ("latin", "Vejret er meget fint i dag og børnene leger i haven. "
           "Jeg vil gerne vide hvornår toget kører i morgen tidlig. Denne "
           "bog blev skrevet af en berømt forfatter for mange år siden. Vi "
           "har ventet på resultaterne af valget hele natten."),
    "no": ("latin", "Været er veldig fint i dag og barna leker i hagen. Jeg "
           "vil gjerne vite når toget går i morgen tidlig. Denne boken ble "
           "skrevet av en berømt forfatter for mange år siden. Vi har "
           "ventet på resultatene av valget hele natten."),
    "fi": ("latin", "Sää on tänään erittäin kaunis ja lapset leikkivät "
           "puutarhassa. Haluaisin tietää mihin aikaan juna lähtee huomenna "
           "aamulla. Tämän kirjan kirjoitti kuuluisa kirjailija monta "
           "vuotta sitten. Olemme odottaneet vaalien tuloksia koko yön."),
    "pl": ("latin", "Pogoda jest dzisiaj bardzo ładna i dzieci bawią się w "
           "ogrodzie. Chciałbym wiedzieć o której godzinie odjeżdża pociąg "
           "jutro rano. Ta książka została napisana przez słynnego pisarza "
           "wiele lat temu. Czekaliśmy na wyniki wyborów całą noc."),
    "cs": ("latin", "Počasí je dnes velmi pěkné a děti si hrají na zahradě. "
           "Chtěl bych vědět, v kolik hodin zítra ráno odjíždí vlak. Tuto "
           "knihu napsal slavný spisovatel před mnoha lety. Celou noc jsme "
           "čekali na výsledky voleb."),
    "sk": ("latin", "Počasie je dnes veľmi pekné a deti sa hrajú v záhrade. "
           "Chcel by som vedieť, o ktorej hodine zajtra ráno odchádza vlak. "
           "Túto knihu napísal slávny spisovateľ pred mnohými rokmi. Celú "
           "noc sme čakali na výsledky volieb."),
    "sl": ("latin", "Vreme je danes zelo lepo in otroci se igrajo na vrtu. "
           "Rad bi vedel, ob kateri uri jutri zjutraj odpelje vlak. To "
           "knjigo je napisal slavni pisatelj pred mnogimi leti. Vso noč "
           "smo čakali na rezultate volitev."),
    "hr": ("latin", "Vrijeme je danas vrlo lijepo i djeca se igraju u vrtu. "
           "Želio bih znati u koliko sati sutra ujutro polazi vlak. Ovu je "
           "knjigu napisao slavni pisac prije mnogo godina. Cijelu noć smo "
           "čekali rezultate izbora."),
    "ro": ("latin", "Vremea este foarte frumoasă astăzi și copiii se joacă "
           "în grădină. Aș vrea să știu la ce oră pleacă trenul mâine "
           "dimineață. Această carte a fost scrisă de un autor celebru acum "
           "mulți ani. Am așteptat rezultatele alegerilor toată noaptea."),
    "hu": ("latin", "Az idő ma nagyon szép és a gyerekek a kertben "
           "játszanak. Szeretném tudni, hogy holnap reggel hánykor indul a "
           "vonat. Ezt a könyvet egy híres író írta sok évvel ezelőtt. "
           "Egész éjjel vártuk a választás eredményeit."),
    "tr": ("latin", "Bugün hava çok güzel ve çocuklar bahçede oynuyorlar. "
           "Trenin yarın sabah saat kaçta kalktığını bilmek istiyorum. Bu "
           "kitap yıllar önce ünlü bir yazar tarafından yazıldı. Bütün "
           "gece seçim sonuçlarını bekledik."),
    "et": ("latin", "Ilm on täna väga ilus ja lapsed mängivad aias. Ma "
           "tahaksin teada, mis kell rong homme hommikul väljub. Selle "
           "raamatu kirjutas kuulus kirjanik palju aastaid tagasi. Me "
           "ootasime valimiste tulemusi terve öö."),
    "lv": ("latin", "Laiks šodien ir ļoti jauks un bērni spēlējas dārzā. Es "
           "gribētu zināt, cikos rīt no rīta atiet vilciens. Šo grāmatu "
           "pirms daudziem gadiem uzrakstīja slavens rakstnieks. Mēs visu "
           "nakti gaidījām vēlēšanu rezultātus."),
    "lt": ("latin", "Oras šiandien labai gražus ir vaikai žaidžia sode. "
           "Norėčiau žinoti, kelintą valandą rytoj ryte išvyksta "
           "traukinys. Šią knygą prieš daugelį metų parašė garsus "
           "rašytojas. Visą naktį laukėme rinkimų rezultatų."),
    "ca": ("latin", "El temps és molt bonic avui i els nens juguen al "
           "jardí. M'agradaria saber a quina hora surt el tren demà al "
           "matí. Aquest llibre va ser escrit per un autor famós fa molts "
           "anys. Hem estat esperant els resultats de les eleccions tota "
           "la nit."),
    "gl": ("latin", "O tempo está moi bonito hoxe e os nenos xogan no "
           "xardín. Gustaríame saber a que hora sae o tren mañá pola mañá. "
           "Este libro foi escrito por un autor famoso hai moitos anos. "
           "Estivemos agardando os resultados das eleccións toda a noite."),
    "eu": ("latin", "Eguraldia oso polita da gaur eta haurrak lorategian "
           "jolasten ari dira. Jakin nahiko nuke bihar goizean zer ordutan "
           "ateratzen den trena. Liburu hau idazle ospetsu batek idatzi "
           "zuen duela urte asko. Gau osoan hauteskundeen emaitzen zain "
           "egon gara."),
    "cy": ("latin", "Mae'r tywydd yn braf iawn heddiw ac mae'r plant yn "
           "chwarae yn yr ardd. Hoffwn wybod pryd mae'r trên yn gadael "
           "bore yfory. Ysgrifennwyd y llyfr hwn gan awdur enwog "
           "flynyddoedd lawer yn ôl. Rydym wedi bod yn aros am "
           "ganlyniadau'r etholiad drwy'r nos."),
    "ga": ("latin", "Tá an aimsir go hálainn inniu agus tá na páistí ag "
           "imirt sa ghairdín. Ba mhaith liom a fhios a bheith agam cén "
           "t-am a fhágann an traein maidin amárach. Scríobh údar cáiliúil "
           "an leabhar seo blianta fada ó shin. Bhíomar ag fanacht le "
           "torthaí an toghcháin ar feadh na hoíche."),
    "is": ("latin", "Veðrið er mjög gott í dag og börnin eru að leika sér í "
           "garðinum. Ég vildi gjarnan vita hvenær lestin fer í "
           "fyrramálið. Þessi bók var skrifuð af frægum rithöfundi fyrir "
           "mörgum árum. Við höfum beðið eftir úrslitum kosninganna alla "
           "nóttina."),
    "sq": ("latin", "Moti është shumë i bukur sot dhe fëmijët po luajnë në "
           "kopsht. Do të doja të dija në çfarë ore niset treni nesër në "
           "mëngjes. Ky libër u shkrua nga një autor i famshëm shumë vite "
           "më parë. Kemi pritur rezultatet e zgjedhjeve gjithë natën."),
    "mt": ("latin", "It-temp huwa sabiħ ħafna llum u t-tfal qed jilagħbu "
           "fil-ġnien. Nixtieq inkun naf fi x'ħin jitlaq il-ferrovija "
           "għada filgħodu. Dan il-ktieb inkiteb minn awtur famuż ħafna "
           "snin ilu. Konna qed nistennew ir-riżultati tal-elezzjoni "
           "il-lejl kollu."),
    "vi": ("latin", "Thời tiết hôm nay rất đẹp và trẻ em đang chơi trong "
           "vườn. Tôi muốn biết mấy giờ tàu khởi hành vào sáng mai. Cuốn "
           "sách này được viết bởi một tác giả nổi tiếng nhiều năm trước. "
           "Chúng tôi đã chờ kết quả bầu cử suốt đêm."),
    "id": ("latin", "Cuaca hari ini sangat bagus dan anak-anak sedang "
           "bermain di taman. Saya ingin tahu jam berapa kereta berangkat "
           "besok pagi. Buku ini ditulis oleh seorang penulis terkenal "
           "bertahun-tahun yang lalu. Kami telah menunggu hasil pemilihan "
           "sepanjang malam."),
    "ms": ("latin", "Cuaca hari ini sangat baik dan kanak-kanak sedang "
           "bermain di taman. Saya ingin tahu pukul berapa kereta api "
           "bertolak esok pagi. Buku ini telah ditulis oleh seorang "
           "penulis terkenal banyak tahun dahulu. Kami telah menunggu "
           "keputusan pilihan raya sepanjang malam."),
    "tl": ("latin", "Napakaganda ng panahon ngayon at naglalaro ang mga "
           "bata sa hardin. Gusto kong malaman kung anong oras aalis ang "
           "tren bukas ng umaga. Ang aklat na ito ay isinulat ng isang "
           "sikat na may-akda maraming taon na ang nakalipas. Naghintay "
           "kami sa mga resulta ng halalan buong gabi."),
    "sw": ("latin", "Hali ya hewa ni nzuri sana leo na watoto wanacheza "
           "bustanini. Ningependa kujua treni inaondoka saa ngapi kesho "
           "asubuhi. Kitabu hiki kiliandikwa na mwandishi maarufu miaka "
           "mingi iliyopita. Tumekuwa tukisubiri matokeo ya uchaguzi usiku "
           "kucha."),
    "af": ("latin", "Die weer is vandag baie mooi en die kinders speel in "
           "die tuin. Ek wil graag weet hoe laat die trein môreoggend "
           "vertrek. Hierdie boek is baie jare gelede deur 'n beroemde "
           "skrywer geskryf. Ons het die hele nag op die uitslae van die "
           "verkiesing gewag."),
    "az": ("latin", "Bu gün hava çox gözəldir və uşaqlar bağçada "
           "oynayırlar. Sabah səhər qatarın saat neçədə yola düşdüyünü "
           "bilmək istəyirəm. Bu kitab illər əvvəl məşhur bir yazıçı "
           "tərəfindən yazılmışdır. Bütün gecə seçki nəticələrini "
           "gözləmişik."),
    "uz": ("latin", "Bugun havo juda yaxshi va bolalar bog'da o'ynashmoqda. "
           "Ertaga ertalab poyezd soat nechada jo'nashini bilmoqchiman. Bu "
           "kitob ko'p yillar oldin mashhur yozuvchi tomonidan yozilgan. "
           "Biz tun bo'yi saylov natijalarini kutdik."),
    "so": ("latin", "Cimiladu maanta aad bay u fiican tahay carruurtuna "
           "waxay ku ciyaarayaan beerta. Waxaan jeclaan lahaa inaan ogaado "
           "goorma ayuu tareenku baxayaa berri subax. Buuggan waxaa qoray "
           "qoraa caan ah sanado badan ka hor. Habeenkii oo dhan waxaan "
           "sugaynay natiijada doorashada."),
    "ha": ("latin", "Yanayin yau yana da kyau sosai kuma yara suna wasa a "
           "lambun. Ina so in san lokacin da jirgin kasa zai tashi gobe da "
           "safe. An rubuta wannan littafi da wani shahararren marubuci "
           "shekaru da yawa da suka wuce. Mun jira sakamakon zaben dare "
           "daya."),
    "yo": ("latin", "Oju ojo dara pupo loni awon omode si n sere ninu ogba. "
           "Mo fe mo igba ti oko oju irin yoo lo ni owuro ola. Onkowe "
           "olokiki kan ko iwe yii ni odun pupo seyin. A ti n duro de "
           "esi idibo ni gbogbo oru."),
    "eo": ("latin", "La vetero estas tre bela hodiaŭ kaj la infanoj ludas "
           "en la ĝardeno. Mi ŝatus scii je kioma horo la trajno foriros "
           "morgaŭ matene. Tiu ĉi libro estis verkita de fama aŭtoro antaŭ "
           "multaj jaroj. Ni atendis la rezultojn de la elekto la tutan "
           "nokton."),
    # --- cyrillic -------------------------------------------------------
    "ru": ("cyrillic", "Погода сегодня очень хорошая, и дети играют в "
           "саду. Я хотел бы знать, во сколько завтра утром отправляется "
           "поезд. Эта книга была написана известным писателем много лет "
           "назад. Мы всю ночь ждали результатов выборов."),
    "uk": ("cyrillic", "Погода сьогодні дуже гарна, і діти граються в "
           "саду. Я хотів би знати, о котрій годині завтра вранці "
           "відправляється потяг. Цю книгу написав відомий письменник "
           "багато років тому. Ми всю ніч чекали на результати виборів."),
    "bg": ("cyrillic", "Времето днес е много хубаво и децата играят в "
           "градината. Бих искал да знам в колко часа тръгва влакът утре "
           "сутринта. Тази книга е написана от известен писател преди "
           "много години. Цяла нощ чакахме резултатите от изборите."),
    "sr": ("cyrillic", "Време је данас веома лепо и деца се играју у "
           "башти. Желео бих да знам у колико сати сутра ујутру полази "
           "воз. Ову књигу је написао познати писац пре много година. "
           "Целу ноћ смо чекали резултате избора."),
    "mk": ("cyrillic", "Времето денес е многу убаво и децата си играат во "
           "градината. Би сакал да знам во колку часот утре наутро "
           "тргнува возот. Оваа книга ја напиша познат писател пред многу "
           "години. Цела ноќ ги чекавме резултатите од изборите."),
    "be": ("cyrillic", "Надвор'е сёння вельмі добрае, і дзеці гуляюць у "
           "садзе. Я хацеў бы ведаць, а якой гадзіне заўтра раніцай "
           "адпраўляецца цягнік. Гэтую кнігу напісаў вядомы пісьменнік "
           "шмат гадоў таму. Мы ўсю ноч чакалі вынікаў выбараў."),
    "kk": ("cyrillic", "Бүгін ауа райы өте жақсы, балалар бақшада ойнап "
           "жүр. Пойыздың ертең таңертең сағат нешеде жүретінін білгім "
           "келеді. Бұл кітапты көп жыл бұрын атақты жазушы жазған. Біз "
           "түні бойы сайлау нәтижелерін күттік."),
    # --- arabic script --------------------------------------------------
    "ar": ("arabic", "الطقس جميل جدا اليوم والأطفال يلعبون في الحديقة. "
           "أود أن أعرف في أي ساعة يغادر القطار صباح الغد. كتب هذا الكتاب "
           "مؤلف مشهور منذ سنوات عديدة. انتظرنا نتائج الانتخابات طوال "
           "الليل."),
    "fa": ("arabic", "هوا امروز بسیار خوب است و بچه‌ها در باغ بازی "
           "می‌کنند. می‌خواهم بدانم قطار فردا صبح ساعت چند حرکت می‌کند. "
           "این کتاب سال‌ها پیش توسط نویسنده‌ای مشهور نوشته شده است. تمام "
           "شب منتظر نتایج انتخابات بودیم."),
    "ur": ("arabic", "آج موسم بہت اچھا ہے اور بچے باغ میں کھیل رہے ہیں۔ "
           "میں جاننا چاہتا ہوں کہ ٹرین کل صبح کتنے بجے روانہ ہوگی۔ یہ "
           "کتاب کئی سال پہلے ایک مشہور مصنف نے لکھی تھی۔ ہم ساری رات "
           "انتخابات کے نتائج کا انتظار کرتے رہے۔"),
    # --- devanagari -----------------------------------------------------
    "hi": ("devanagari", "आज मौसम बहुत अच्छा है और बच्चे बगीचे में खेल "
           "रहे हैं। मैं जानना चाहता हूँ कि कल सुबह ट्रेन कितने बजे "
           "छूटती है। यह किताब कई साल पहले एक प्रसिद्ध लेखक ने लिखी थी। "
           "हम पूरी रात चुनाव के नतीजों का इंतज़ार करते रहे।"),
    "mr": ("devanagari", "आज हवामान खूप छान आहे आणि मुले बागेत खेळत "
           "आहेत. उद्या सकाळी ट्रेन किती वाजता सुटते हे मला जाणून घ्यायचे "
           "आहे. हे पुस्तक अनेक वर्षांपूर्वी एका प्रसिद्ध लेखकाने लिहिले "
           "होते. आम्ही रात्रभर निवडणुकीच्या निकालांची वाट पाहत होतो."),
    "ne": ("devanagari", "आज मौसम धेरै राम्रो छ र बालबालिकाहरू बगैंचामा "
           "खेलिरहेका छन्। भोलि बिहान रेल कति बजे छुट्छ भनेर म जान्न "
           "चाहन्छु। यो पुस्तक धेरै वर्ष पहिले एक प्रसिद्ध लेखकले लेखेका "
           "थिए। हामी रातभर चुनावको नतिजा पर्खिरह्यौं।"),
}



# Additional seed text for confusable clusters (Scandinavian, Slavic,
# Iberian, Malay, Turkic): appended to the base seeds at profile build.
_SEED_EXTRA: Dict[str, str] = {
"da": "Jeg købte nogle æbler og pærer på markedet i eftermiddags. Hvordan har du det i dag, og hvad skal vi lave i weekenden? Det er vigtigt at huske sine venner, når man flytter til en ny by. Om vinteren går vi ofte en lang tur ned til stranden, hvor bølgerne slår mod klipperne, og bagefter drikker vi varm kakao hjemme i køkkenet. Jeg ved ikke om vi når toget, men vi kan spørge nogen på stationen om hvornår det kører. Der var engang en lille dreng, som boede i et lille hus ved skoven, og hver morgen gik han ned ad vejen til skolen sammen med sine venner.",
"no": "Jeg kjøpte noen epler og pærer på markedet i ettermiddag. Hvordan har du det i dag, og hva skal vi gjøre i helgen? Det er viktig å huske vennene sine når man flytter til en ny by. Om vinteren går vi ofte en lang tur ned til stranden, hvor bølgene slår mot klippene, og etterpå drikker vi varm kakao hjemme på kjøkkenet. Jeg vet ikke om vi rekker toget, men vi kan spørre noen på stasjonen om når det går. Det var en gang en liten gutt som bodde i et lite hus ved skogen, og hver morgen gikk han nedover veien til skolen sammen med vennene sine.",
"sv": "Jag köpte några äpplen och päron på marknaden i eftermiddags. Hur mår du idag, och vad ska vi göra i helgen? Det är viktigt att komma ihåg sina vänner när man flyttar till en ny stad. På vintern går vi ofta en lång promenad ner till stranden, där vågorna slår mot klipporna, och efteråt dricker vi varm choklad hemma i köket.",
"nl": "In de winter maken we vaak een lange wandeling naar het strand, waar de golven tegen de rotsen slaan, en daarna drinken we warme chocolademelk thuis in de keuken.",
"it": "Ho comprato delle mele e delle pere al mercato questo pomeriggio. Come stai oggi e cosa facciamo nel fine settimana? È importante ricordare gli amici quando ci si trasferisce in una nuova città.",
"fr": "J'ai acheté des pommes et des poires au marché cet après-midi. Comment vas-tu aujourd'hui et que faisons-nous ce week-end ? Il est important de se souvenir de ses amis quand on déménage dans une nouvelle ville.",
"cs": "Dnes odpoledne jsem na trhu koupil několik jablek a hrušek. Jak se dnes máš a co budeme dělat o víkendu? Je důležité pamatovat na své přátele, když se člověk stěhuje do nového města.",
"sk": "Dnes popoludní som na trhu kúpil niekoľko jabĺk a hrušiek. Ako sa dnes máš a čo budeme robiť cez víkend? Je dôležité pamätať na svojich priateľov, keď sa človek sťahuje do nového mesta.",
"id": "Saya membeli beberapa apel dan pir di pasar sore ini. Bagaimana kabarmu hari ini, dan apa yang akan kita lakukan akhir pekan ini? Penting untuk mengingat teman-temanmu ketika pindah ke kota baru. Pada musim hujan kami sering berjalan kaki ke pantai, tempat ombak memecah di atas batu karang, dan setelah itu kami minum teh hangat di rumah.",
"ms": "Saya membeli beberapa epal dan pir di pasar petang tadi. Apa khabar anda hari ini, dan apakah yang akan kita lakukan pada hujung minggu ini? Adalah penting untuk mengingati rakan-rakan anda apabila berpindah ke bandar baharu. Pada musim hujan kami selalu berjalan kaki ke pantai, di mana ombak memecah di atas batu karang, dan selepas itu kami minum teh panas di rumah.",
"es": "Compré algunas manzanas y peras en el mercado esta tarde. ¿Cómo estás hoy y qué vamos a hacer el fin de semana? Es importante recordar a los amigos cuando uno se muda a una ciudad nueva.",
"pt": "Comprei algumas maçãs e peras no mercado esta tarde. Como você está hoje e o que vamos fazer no fim de semana? É importante lembrar dos amigos quando a gente se muda para uma cidade nova.",
"uk": "Сьогодні по обіді я купив кілька яблук і груш на ринку. Як ти почуваєшся сьогодні, і що ми робитимемо на вихідних? Важливо пам'ятати про друзів, коли переїжджаєш до нового міста.",
"ru": "Сегодня после обеда я купил несколько яблок и груш на рынке. Как ты себя чувствуешь сегодня, и что мы будем делать на выходных? Важно помнить о друзьях, когда переезжаешь в новый город.",
"bg": "Днес следобед купих няколко ябълки и круши на пазара. Как се чувстваш днес и какво ще правим през уикенда? Важно е да помниш приятелите си, когато се местиш в нов град.",
"tr": "Dün akşam arkadaşlarımla birlikte deniz kenarında uzun bir yürüyüş yaptık ve sonra evde sıcak çay içtik. Gelecek yıl üniversitede mühendislik okumak istiyorum.",
"az": "Dünən axşam dostlarımla birlikdə dəniz kənarında uzun bir gəzinti etdik və sonra evdə isti çay içdik. Gələn il universitetdə mühəndislik oxumaq istəyirəm."
}


def _ngram_counts(text: str, n_min: int = 1, n_max: int = 4) -> Counter:
    """Lowercased char 1..4-grams over a space-normalized window. Measured
    against rank-order (Cavnar-Trenkle) and trigram-only cosine on held-out
    sentences: idf-weighted 1-4-gram cosine won (27/29 vs 19/26 and 20/30)."""
    t = " " + " ".join(text.lower().split()) + " "
    c: Counter = Counter()
    for n in range(n_min, n_max + 1):
        for i in range(len(t) - n + 1):
            c[t[i:i + n]] += 1
    return c


class NgramLanguageClassifier:
    """IDF-weighted log-tf cosine over char 1-4-gram profiles, script-gated.

    IDF is computed across the language profiles themselves, so n-grams
    shared by many languages (plain ascii pairs, spaces) stop dominating and
    diacritic-bearing / language-specific sequences decide."""

    def __init__(self) -> None:
        self._profiles: Optional[Dict[str, Tuple[str, Dict[str, float], float]]] = None
        self._idf: Dict[str, float] = {}
        self._idf_default = 0.0

    def _weigh(self, counts: Counter) -> Dict[str, float]:
        return {k: (1.0 + math.log(v)) * self._idf.get(k, self._idf_default)
                for k, v in counts.items()}

    def _ensure_profiles(self) -> Dict[str, Tuple[str, Dict[str, float], float]]:
        if self._profiles is None:
            raw = {code: (group, _ngram_counts(seed + " " + _SEED_EXTRA.get(code, "")))
                   for code, (group, seed) in _SEEDS.items()}
            df: Counter = Counter()
            for _, (_, p) in raw.items():
                for k in p:
                    df[k] += 1
            n_langs = len(raw)
            self._idf = {k: math.log(1 + n_langs / d) for k, d in df.items()}
            self._idf_default = math.log(1 + n_langs)
            prof: Dict[str, Tuple[str, Dict[str, float], float]] = {}
            for code, (group, p) in raw.items():
                v = self._weigh(p)
                norm = math.sqrt(sum(x * x for x in v.values()))
                prof[code] = (group, v, norm)
            self._profiles = prof
        return self._profiles

    @staticmethod
    def _script_of(sample: str) -> Tuple[Optional[str], Optional[str], float]:
        """Returns (single_script_lang, group, coverage) for the sample."""
        single: Dict[str, int] = {}
        group: Dict[str, int] = {}
        alpha = 0
        for ch in sample:
            if not ch.isalpha():
                continue
            alpha += 1
            cp = ord(ch)
            for code, (lo, hi) in _SINGLE_SCRIPT:
                if lo <= cp <= hi:
                    single[code] = single.get(code, 0) + 1
                    break
            else:
                for g, (lo, hi) in _GROUP_SCRIPT:
                    if lo <= cp <= hi:
                        group[g] = group.get(g, 0) + 1
                        break
        if not alpha:
            return None, None, 0.0
        # Japanese text mixes kana with Han: any kana presence wins over zh
        if single.get("ja", 0) >= 2:
            return "ja", None, (single["ja"] + single.get("zh", 0)) / alpha
        if single:
            code, n = max(single.items(), key=lambda kv: kv[1])
            if n / alpha > 0.3:
                return code, None, n / alpha
        if group:
            g, n = max(group.items(), key=lambda kv: kv[1])
            if n / alpha > 0.3:
                return None, g, n / alpha
        return None, "latin", 1.0

    def classify(self, text: str) -> Tuple[str, float]:
        """Returns (language_code, confidence in [0,1])."""
        sample = text[:2000]
        single, group, coverage = self._script_of(sample)
        if single is not None:
            return single, min(1.0, 0.5 + coverage)
        if group is None:
            return "en", 0.0
        profiles = self._ensure_profiles()
        q = self._weigh(_ngram_counts(sample))
        qnorm = math.sqrt(sum(v * v for v in q.values()))
        if qnorm == 0:
            return "en", 0.0
        scored: List[Tuple[float, str]] = []
        for code, (g, p, pnorm) in profiles.items():
            if g != group:
                continue
            dot = sum(v * p[k] for k, v in q.items() if k in p)
            scored.append((dot / (qnorm * pnorm), code))
        if not scored:
            return "en", 0.0
        scored.sort(reverse=True)
        best_sim, best = scored[0]
        second = scored[1][0] if len(scored) > 1 else 0.0
        # confidence: absolute similarity tempered by the margin over the
        # runner-up (same-family neighbours legitimately overlap). Scales
        # chosen so held-out single sentences land ~0.6-0.9 when correct
        # (idf-cosine absolute sims run ~0.1-0.3) and ambiguous short text
        # falls under the 0.5 LLM-escalation threshold.
        margin = best_sim - second
        conf = max(0.0, min(1.0, 2.5 * best_sim + 4.0 * margin))
        return best, conf

    @property
    def languages(self) -> List[str]:
        return sorted(set(_SEEDS) | {c for c, _ in _SINGLE_SCRIPT})


_classifier: Optional[NgramLanguageClassifier] = None


def classify(text: str) -> Tuple[str, float]:
    global _classifier
    if _classifier is None:
        _classifier = NgramLanguageClassifier()
    return _classifier.classify(text)
